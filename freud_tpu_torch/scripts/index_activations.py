"""Build the feature-major search index for a collected activation store.

Usage: python -m freud_tpu_torch.scripts.index_activations --config cfg.json
(feature-config schema: uses ``out_folder`` and ``layer_name``). After
indexing, ``/top_files`` queries read one feature plane instead of scanning
the whole store (``freud_tpu_torch.data.feature_store``). The index is
byte-identical to the one ``freud_tpu.scripts.index_activations`` writes.
"""

from __future__ import annotations

import argparse
import json

from ..data.feature_store import (build_feature_major_index,
                                  build_sparse_feature_major_index)
from ..data.store import ActivationStoreReader


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True,
                        help="Path to feature configuration file")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    folder, layer = config["out_folder"], config["layer_name"]
    # dense stores get the transposed-plane index; indexed (TopK-SAE) stores
    # the CSR-by-feature sparse index — same O(one-plane) query either way
    reader = ActivationStoreReader(folder, layer)
    if reader.activation_type == "indexed":
        path = build_sparse_feature_major_index(folder, layer)
    else:
        path = build_feature_major_index(folder, layer)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
