"""Readings that set the limits of a ``collect_lm`` cell (Uni-MoE-2.0-Omni
at a language-model layer): sound runs, the control, and the program with a
fault planted in its MoE or its rotary positions.

    python3 portbench/control_lm.py --workload uni_moe_omni.collect_sae --seeds 1 2 3
        [--seconds 2] [--fault null_as_expert|top2|renormalized|no_fixed|
                               mrope_permuted|router_bf16]

Each seed runs the cell as the benchmark does (a short window) and prints
one JSON line with the program's compared numbers (``checks``) and, without
a fault, the control's (``control``): the plain reference with float8 e4m3
products in the program's place, judged by the same comparisons and held to
the cell's limits (``control_correct``, which has to come out false).
``--fault`` plants one fault in the program first (its plain PyTorch
version stands in for the kernel it changes):

* ``null_as_expert``: the null expert computes, as a fifth expert reading
  the first expert's weights, with its p as the combine weight;
* ``top2``: the top-p rule replaced by a fixed top-2;
* ``renormalized``: the combine weights renormalised over the selection;
* ``no_fixed``: the fixed experts dropped;
* ``mrope_permuted``: the M-RoPE table's sections laid in the order h, w,
  t, so each frequency pair turns at another pair's frequency (with t, h
  and w ids equal, a permutation of the axes alone would change nothing);
* ``router_bf16``: the router's product in bf16 (its input, weights and
  logits rounded to bf16).

The benchmark's own runs never run this; ``control.py`` does the same for
the other kinds.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)

FAULTS = ("null_as_expert", "top2", "renormalized", "no_fixed", "mrope_permuted",
          "router_bf16")


def plant(fault: str) -> None:
    import torch

    from freud_tpu_torch.models.omni import model as omni_model
    from freud_tpu_torch.ops import moe

    route = moe.route
    if fault == "null_as_expert":
        def faulty(u, w, top_p, top_k):
            probs, sel, wsel = route(u, w, top_p, top_k)
            n_dyn = w.shape[0] - 1  # the router's outputs but the null one
            return probs, torch.where(sel >= n_dyn, 0, sel).to(sel.dtype), wsel
    elif fault == "top2":
        def faulty(u, w, top_p, top_k):
            return moe.route_plain(u, w, 2.0, top_k)
    elif fault == "renormalized":
        def faulty(u, w, top_p, top_k):
            probs, sel, wsel = route(u, w, top_p, top_k)
            return probs, sel, wsel / wsel.sum(1, keepdim=True)
    elif fault == "router_bf16":
        def faulty(u, w, top_p, top_k):
            logits = (u.bfloat16() @ w.bfloat16().T).float()
            probs = torch.softmax(logits, dim=-1)
            return (probs, *moe.select(probs, top_p, top_k))
    elif fault == "no_fixed":
        omni_model.fixed_experts = lambda u, gate, up, down: torch.zeros_like(u)
        return
    elif fault == "mrope_permuted":
        table = omni_model.rope_table

        def permuted(pos, head_dim, theta, sections):
            cos, sin = table(pos, head_dim, theta, sections)
            t, h = sections[0], sections[0] + sections[1]
            half = head_dim // 2
            order = [*range(t, h), *range(h, half), *range(t)]
            order = order + [half + j for j in order]
            return cos[..., order], sin[..., order]

        omni_model.rope_table = permuted
        return
    else:
        raise SystemExit(f"unknown fault {fault!r} (one of {', '.join(FAULTS)})")
    faulty.launches = faulty.captured = 0  # the wrappers count under the module's name
    moe.route = faulty


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None, choices=FAULTS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from portbench import core

    if args.fault:
        plant(args.fault)
    limits = core.resolve_cell(args.workload, ROOT).limits
    for seed in args.seeds:
        r = core.run_cell(args.workload, seed, args.seconds, False, device=args.device,
                          root=ROOT, control=args.fault is None)
        control = r.get("control")
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "correct": r["correct"], "failed": r["failed"],
                "checks": {k: v["value"] for k, v in r["checks"].items()},
                "metrics": {k: v["value"] for k, v in r["metrics"].items()},
                "control": control}
        if control is not None:
            line["control_correct"] = core.judge({k: control.get(k) for k in limits},
                                                 limits)[0]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
