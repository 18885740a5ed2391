"""The whole batch's share of the H100's dense bf16 peak: the frozen count
of one 30-s clip through the log-mel, the conv stem and the blocks up to the
tap, plus the SAE encode's product, times the files of the unprofiled part
of the traced window over its seconds."""

from portbench import work


def read(r):
    w = r.w
    if not w.get("files"):
        return None
    wh = r.config["whisper"]
    d, t = wh["n_audio_state"], wh["n_audio_ctx"]
    per_file = (work.encoder_flops_to_tap(wh["n_mels"], d, t,
                                          work.tapped_blocks(r.config["layer_name"]))
                + work.sae_encode_flops(t, d, d * r.config["sae"]["expansion_factor"]))
    return work.peak_share_pct(per_file * w["files"], w["seconds"])
