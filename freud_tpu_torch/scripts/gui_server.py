"""GUI server CLI — the flags of ``freud_tpu.scripts.gui_server``
(--config / --from_disk / --files_to_search / --no_audio_upload, port
5555, --host / --port / --precision).

The server runs on the card unless the config says ``"device": "cpu"``.

Usage: python -m freud_tpu_torch.scripts.gui_server --config cfg.json --from_disk
"""

from __future__ import annotations

import argparse
import json

from ..server.app import serve_forever


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--config", type=str, required=True,
                        help="Path to feature configuration file")
    parser.add_argument("--from_disk", action="store_true",
                        help="Load activations from a collected store")
    parser.add_argument("--files_to_search", type=int, default=None,
                        help="Number of files to search (None = all)")
    parser.add_argument("--no_audio_upload", action="store_true",
                        help="Disable the audio upload endpoints")
    parser.add_argument("--host", type=str, default="0.0.0.0")
    parser.add_argument("--port", type=int, default=5555)
    parser.add_argument("--precision", default=None,
                        choices=["float32", "bfloat16"],
                        help="serving runtime precision (encoder and decoder)")
    args = parser.parse_args(argv)
    with open(args.config) as f:
        config = json.load(f)
    if args.precision:
        config["precision"] = args.precision
    serve_forever(
        config,
        from_disk=args.from_disk,
        files_to_search=args.files_to_search,
        no_audio_upload=args.no_audio_upload,
        host=args.host,
        port=args.port,
    )


if __name__ == "__main__":
    main()
