"""Export a trained model to a self-contained ``torch.export`` program
(port of ``tools/export_model.py``).

    python -m dist_tpu_torch.tools.export_model \\
        --cfg configs/projects/dist/k400/vit-b16-8+16f-eval.yaml \\
        --out k400_b16.pt2 --batch-size 8 [--device cpu] \\
        [--verify] [KEY VALUE ...]

Checkpoint resolution follows the test task (TEST.CHECKPOINT_FILE_PATH >
last in OUTPUT_DIR > TRAIN's); the program bakes in the weights, the
label-text features, the uint8 normalisation and the head's eval
activation (``serving/export.py``). It is traced on the card unless
``--device cpu`` is given, and runs on either device (the JAX tool's
``--platforms``). ``--verify`` loads the written file and holds its scores
to the serving engine's on a random 2-clip request (``atol`` 5e-3, the
same top-3). Run the program with only ``torch`` and ``dist_tpu_torch.ops``:

    from dist_tpu_torch.serving.export import load_predictor
    predict, meta = load_predictor("k400_b16.pt2")      # or device="cpu"
    scores = predict(clips_u8)                          # (n, classes)
"""

import argparse
import sys

# the JAX tool's bound: bf16 configs tolerate the engine's bucket (the
# request's own batch) against the program's fixed batch
VERIFY_ATOL = 5e-3
VERIFY_CLIPS = 2


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m dist_tpu_torch.tools.export_model",
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--cfg", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="trace on this device (default: the CUDA card)")
    ap.add_argument("--verify", action="store_true",
                    help="load the written file and compare scores against "
                         "the in-process engine on a random clip")
    ap.add_argument("opts", nargs=argparse.REMAINDER,
                    help="dotted-key config overrides")
    args = ap.parse_args(argv)

    from dist_tpu_torch.config import load_config
    from dist_tpu_torch.serving.export import (
        export_predictor,
        load_predictor,
        save_exported,
    )

    cfg = load_config(args.cfg, opts=args.opts, make_output_dir=False)
    program, meta = export_predictor(cfg, batch_size=args.batch_size,
                                     device=args.device)
    save_exported(args.out, program, meta)

    if args.verify:
        import numpy as np

        from dist_tpu_torch.serving.engine import InferenceEngine

        predict, _ = load_predictor(args.out, device=args.device)
        rng = np.random.default_rng(0)
        clip = rng.integers(0, 255, (VERIFY_CLIPS, meta["num_frames"],
                                     meta["crop"], meta["crop"], 3),
                            dtype=np.uint8)
        got = predict(clip)
        engine = InferenceEngine(cfg, batch_size=args.batch_size,
                                 device=args.device)
        want = engine.predict(clip)
        np.testing.assert_allclose(got, want, rtol=0, atol=VERIFY_ATOL)
        for g, w in zip(got, want):
            if not np.array_equal(np.argsort(g)[::-1][:3],
                                  np.argsort(w)[::-1][:3]):
                raise AssertionError(f"top-3 differ: {g} against {w}")
        print(f"verify OK: exported scores match the engine "
              f"(shape {got.shape}, max abs diff "
              f"{float(np.abs(got - want).max()):.3g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
