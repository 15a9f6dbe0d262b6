"""``python -m mav_detection_tpu_torch.cli.serve`` — run the TinyYOLO
inference server on the card (protocol in :mod:`mav_detection_tpu_torch.
serve`; ``--device cpu`` runs it on the CPU).

Point a validator at it with ``YOLO_INFERENCE_HOST=http://host:port``.
"""
from __future__ import annotations

import argparse
import logging
from typing import List, Optional


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--port", type=int, default=8125,
                    help="listen port (0 = ephemeral, printed on start)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--yolo-mode", default=None,
                    help="detection mode whose per-mode checkpoint to serve "
                         "(FLOW_UV / FLOW_RADIAL / FLOW_FOE_YOLO); default "
                         "RGB weights")
    ap.add_argument("--batch", type=int, default=8,
                    help="device batch per inference step")
    ap.add_argument("--score-threshold", type=float, default=0.5)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO)
    from mav_detection_tpu_torch.serve import create_server

    server = create_server(port=args.port, host=args.host,
                           mode=args.yolo_mode, batch=args.batch,
                           score_threshold=args.score_threshold,
                           device=args.device)
    bound = server.server_address
    print(f"serving TinyYOLO on http://{bound[0]}:{bound[1]} "
          f"(mode={args.yolo_mode or 'RGB'}, device={server.engine.device})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()


if __name__ == "__main__":
    main()
