"""SAE sweep CLI (PyTorch + CUDA): per-layer or hyperparameter grid.

The config schema of ``freud_tpu.scripts.sweep``, plus ``device``.

Per-layer (config has ``layer_names``): one SAE per layer store trained
together (``freud_tpu_torch.train.sweep.train_sweep``)::

    {
      "data_path": "activations/multilayer",
      "layer_names": ["encoder.blocks.0", "encoder.blocks.1"],
      "variant": "l1",
      "autoencoder_config": {"n_dict_components": 64, "recon_alpha": 1e4},
      "steps": 1000, "batch_size": 8, "out_dir": "runs/sweep"
    }

Hyperparameter grid (config has ``grid`` + a single ``layer_name``): every
combination trains as a member of one sweep over ONE store
(``train_hparam_sweep``; one trainer per ``k`` value)::

    {
      "data_path": "activations/tiny",
      "layer_name": "encoder.blocks.2",
      "variant": "topk",
      "autoencoder_config": {"expansion_factor": 16},
      "grid": {"lr": [1e-4, 4e-4], "k": [16, 32], "auxk_alpha": [0.03125]},
      "steps": 1000, "batch_size": 8, "out_dir": "runs/grid"
    }

``device``: ``cpu`` / ``cuda[:N]``; anything else (or none) means cuda, and
a CUDA device without a card raises.

Usage: python -m freud_tpu_torch.scripts.sweep --config sweep.json
"""

from __future__ import annotations

import argparse
import json

from ..train.sweep import train_hparam_sweep, train_sweep


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True,
                        help="Path to sweep configuration file")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    if "grid" in config:
        if "layer_names" in config:
            raise SystemExit(
                "a grid sweep runs over ONE store: use layer_name (string), "
                "not layer_names")
        stats = train_hparam_sweep(**config)
    else:
        stats = train_sweep(**config)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
