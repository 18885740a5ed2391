"""Readings that set the limits of a ``collect_longcat`` cell (LongCat-Flash-
Omni at a language-model layer): sound runs, the control, and the program
with a fault planted in its attention or its MoE.

    python3 portbench/control_longcat.py --workload longcat_flash_omni.collect_sae \
        --seeds 1 2 3 [--seconds 2] [--fault scales_dropped|shortcut_moved|
                                              identity_dropped|bias_in_weights]

Each seed runs the cell as the benchmark does (a short window) and prints
one JSON line with the program's compared numbers (``checks``) and, without
a fault, the control's (``control``): the plain reference with float8 e4m3
products in the program's place, judged by the same comparisons and held to
the cell's limits (``control_correct``, which has to come out false).
``--fault`` plants one fault in the program first:

* ``scales_dropped``: the MLA's LoRA scales on q and the kv latent left out;
* ``shortcut_moved``: the MoE's output added to h2, before the second MLA,
  instead of at the end of the double layer;
* ``identity_dropped``: the identity entries' weight times u left out of
  the combine (their slots add nothing, as an absent expert's do);
* ``bias_in_weights``: the selection bias added to p in the weights too,
  scale · (p + b) instead of scale · p.

The benchmark's own runs never run this; ``control_lm.py`` does the same for
the Uni-MoE cell.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

FAULTS = ("scales_dropped", "shortcut_moved", "identity_dropped", "bias_in_weights")


def plant(fault: str) -> None:
    import torch

    from freud_tpu_torch import profiling
    from freud_tpu_torch.models.longcat import model as lc_model
    from freud_tpu_torch.ops import moe

    if fault == "scales_dropped":
        from freud_tpu_torch.models.longcat import LongCatConfig

        LongCatConfig.q_scale = LongCatConfig.kv_scale = property(lambda self: 1.0)
        return
    if fault == "shortcut_moved":
        def forward(self, x, cos, sin, counts, prefix, tap):
            shape = x.shape
            h1 = x + self.self_attn[0](self.input_layernorm[0](x), cos, sin)
            u = tap(f"{prefix}.mlp.input", self.post_attention_layernorm[0](h1))
            h2 = h1 + self.mlps[0](u)
            u = u.reshape(-1, shape[-1])
            with profiling.span("lm.moe"):
                routed = self.mlp.route(u, counts, f"{prefix}.mlp", tap)
                zero = torch.zeros_like(u)
                h2 = self.mlp.combine(h2.reshape(-1, shape[-1]), zero, u, routed).reshape(shape)
            h3 = h2 + self.self_attn[1](self.input_layernorm[1](h2), cos, sin)
            return tap(prefix, h3 + self.mlps[1](self.post_attention_layernorm[1](h3)))

        lc_model.DoubleLayer.forward = forward
        return
    if fault == "identity_dropped":
        combine = moe.combine

        def faulty(x, fixed, y, pos, wsel, u=None, sel=None, identity=(0, 0)):
            return combine(x, fixed, y, pos, wsel)
    elif fault == "bias_in_weights":
        route_topk = moe.route_topk

        def faulty(logits, bias, top_k, scale, held, identity):
            probs, sel, wsel, cls = route_topk(logits, bias, top_k, scale, held, identity)
            return probs, sel, scale * (probs + bias).gather(1, sel.long()), cls
    else:
        raise SystemExit(f"unknown fault {fault!r} (one of {', '.join(FAULTS)})")
    faulty.launches = faulty.captured = 0  # the wrappers count under the module's name
    setattr(moe, "combine" if fault == "identity_dropped" else "route_topk", faulty)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--fault", default=None, choices=FAULTS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench import core

    if args.fault:
        plant(args.fault)
    limits = core.resolve_cell(args.workload, ROOT).limits
    for seed in args.seeds:
        r = core.run_cell(args.workload, seed, args.seconds, bool(args.trace),
                          device=args.device, root=ROOT, control=args.fault is None)
        control = r.get("control")
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": r["correct"], "failed": r["failed"],
                "checks": {k: v["value"] for k, v in r["checks"].items()},
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "device": r["device"], "control": control}
        if control is not None:
            line["control_correct"] = core.judge({k: control.get(k) for k in limits},
                                                 limits)[0]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
