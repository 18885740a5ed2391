"""Readings that set the output limits: sound runs, the control, and the
program with a fault planted.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 [--seconds 2]
        [--fault unchanged|half_batch|altered_answer]

Each seed runs the cell as the benchmark does (a short window) and prints
one JSON line with the program's compared numbers (``checks``) and the
control's (``control``): the plain reference computed one precision below
the configuration's, in the program's place (float8 products for a train
step stated in bfloat16; TF32 for a float32 encoder), judged by the same
comparisons and held to the cell's limits as the program is
(``control_correct``, which has to come out false). ``--fault`` plants a
fault in the program first:

* ``unchanged``: the optimizer's update does nothing (a step returns its
  state unchanged);
* ``half_batch``: each train step takes the first half of its batch (the
  mean over the rest);
* ``altered_answer``: the SAE encode's first index of every row is moved
  to the next latent (an answer altered where it is produced).

The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0] = str(ROOT)


def plant(fault: str) -> None:
    if fault == "unchanged":
        from freud_tpu_torch.train import optim

        optim.SAEOptimizer.update = lambda self, grads: None
    elif fault == "half_batch":
        from freud_tpu_torch.train import trainer

        step = trainer.SAETrainer._step
        trainer.SAETrainer._step = lambda self, x, mesh=None: step(
            self, x[: x.shape[0] // 2], mesh)
    elif fault == "altered_answer":
        from freud_tpu_torch.models.sae import topk

        encode = topk.encode

        def altered(params, x, cfg):
            out = encode(params, x, cfg)
            idx = out.top_indices.clone()
            idx[..., 0] = (idx[..., 0] + 1) % params.encoder_weight.shape[0]
            return topk.TopKEncoderOutput(out.top_acts, idx)

        topk.encode = altered
    else:
        raise SystemExit(f"unknown fault {fault!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--fault", default=None)
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
            # the numbers the cell compares (the control may read more)
            line["control_correct"] = core.judge({k: control.get(k) for k in limits},
                                                 limits)[0]
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
