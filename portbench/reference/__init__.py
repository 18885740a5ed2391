"""The plain reference: FREUD's TopK SAE train step, Whisper's log-mel and
encoder, and the SAE encode, in float32 PyTorch and NumPy with TF32 off.

It imports neither JAX, ``freud_tpu`` nor anything of ``freud_tpu_torch``,
and takes nothing the program made: it works out again from the run's
inputs (weights, rows, audio) whatever it compares. ``judge.py`` holds the
comparisons that decide ``correct``.
"""


def pin_f32() -> None:
    """float32 products mean float32: no TF32 in cuBLAS nor cuDNN."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
