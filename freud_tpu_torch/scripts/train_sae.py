"""SAE training CLI (PyTorch + CUDA).

``python -m freud_tpu_torch.scripts.train_sae --config configs/train/tiny_topk.json``:
the config JSON keys splat into ``freud_tpu_torch.train.trainer.train``, as
in ``freud_tpu.scripts.train_sae``. ``device`` is ``cpu`` or ``cuda[:N]``;
any other value (the configs say ``"tpu"``) means cuda. The device cache's
keys (``device_cache_files``, ``device_cache_dtype``, ``fused_steps``,
``val_device_cache``) reach ``train`` the same way, with JAX's meaning.
Prints the run's stats as one JSON line (``steps``, ``steps_per_sec``,
``best_val_loss``, ``run_dir``).
"""

from __future__ import annotations

import argparse
import json

from ..train.trainer import train


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True,
                        help="Path to train configuration file")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    stats = train(**config)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
