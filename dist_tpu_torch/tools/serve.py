"""Serve a model over HTTP with micro-batched inference on the card (port
of ``tools/serve.py``).

    python -m dist_tpu_torch.tools.serve --cfg configs/projects/dist/ssv2/vit-b16-8+16f.yaml \\
        [--port 8080] [--batch 8] [--max-delay-ms 10] [--device cpu] [KEY VALUE ...]

Send clips as ``.npy`` bytes (uint8 (T, S, S, 3)):

    import io, urllib.request, numpy as np
    clip = np.zeros((16, 224, 224, 3), np.uint8)
    buf = io.BytesIO(); np.save(buf, clip)
    req = urllib.request.Request("http://localhost:8080/v1/predict?topk=5",
                                 data=buf.getvalue(), method="POST")
    print(urllib.request.urlopen(req).read().decode())

Checkpoint resolution follows the test task (TEST.CHECKPOINT_FILE_PATH >
last train checkpoint > TRAIN.CHECKPOINT_FILE_PATH); with none the model
serves random weights from RANDOM_SEED. Endpoints: POST /v1/predict, GET
/v1/health, /v1/stats. Runs on the CUDA card; ``--device cpu`` runs on the
CPU.
"""

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.serve", description=__doc__,
        formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--batch", type=int, default=None,
                    help="serving batch (the largest bucket); default "
                         "TEST.BATCH_SIZE")
    ap.add_argument("--max-delay-ms", type=float, default=10.0,
                    help="micro-batching latency budget")
    ap.add_argument("--device", default=None,
                    help="default: the CUDA card; 'cpu' for the CPU")
    ap.add_argument("opts", nargs="*", default=[])
    args = ap.parse_args(argv)

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.serving.server import VideoClassifierServer

    cfg = load_config(args.cfg, list(args.opts), make_output_dir=False)
    server = VideoClassifierServer(cfg, host=args.host, port=args.port,
                                   batch_size=args.batch,
                                   max_delay_ms=args.max_delay_ms,
                                   device=args.device)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
