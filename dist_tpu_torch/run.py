"""CLI entry of the port: the train, test, automatic multi-view test and
submission run list (port of ``runs/run.py``).

    python -m dist_tpu_torch.run --cfg configs/projects/dist/ssv2/vit-b16-8+16f.yaml \
        [--device cpu] [--init_method URL] [KEY VALUE ...]
    torchrun --nproc-per-node N -m dist_tpu_torch.run --cfg ... [KEY VALUE ...]

Builds the run list exactly as ``runs/run.py::_prepare_data`` does:
training (``TRAIN.ENABLE``), the single-view test, then the automatic
multi-view test with the per-dataset view policy (SSV2 3 x 1, Kinetics
and EPIC 10 x 3, ...), overridable with ``TEST.OVERRIDE_MULTI_SCALE_TEST``.
The test entries load the last checkpoint that training wrote; with
``SUBMISSION.ENABLE`` the submission test (10 x 3 views,
``tasks/submission.py``) comes last, and ``TASK_TYPE: submission`` runs
it alone. The list runs in every rank of the data axis
(``parallel/launch.py``): in this process on one card (``--device``,
default the CUDA card) when the axis is one rank, in N spawned processes
when ``TPU.MESH.DATA`` is N (or -1 with N local cards), or in the ranks
``torchrun`` started.
"""

import os
import sys

from dist_tpu_torch.config.config import load_from_args
from dist_tpu_torch.parallel import collectives, launch


def _prepare_data(cfg):
    """[(cfg, task)] in run order; each cfg a copy of ``cfg`` as it stood
    when its entry was added."""
    from dist_tpu_torch.tasks.submission import submission_test
    from dist_tpu_torch.tasks.test import test
    from dist_tpu_torch.tasks.train import train

    if cfg.TASK_TYPE == "submission":
        cfg.TRAIN.ENABLE = False
        cfg.TEST.ENABLE = False
    elif cfg.TASK_TYPE != "classification":
        raise ValueError(f"unknown TASK_TYPE {cfg.TASK_TYPE}")

    run_list = []
    if cfg.TRAIN.ENABLE:
        run_list.append([cfg.deep_copy(), train])
    if cfg.TEST.ENABLE:
        run_list.append([cfg.deep_copy(), test])
        if cfg.TEST.AUTOMATIC_MULTI_SCALE_TEST:
            cfg.LOG_MODEL_INFO = False
            cfg.LOG_CONFIG_INFO = False
            cfg.TEST.NUM_ENSEMBLE_VIEWS = 10
            cfg.TEST.NUM_SPATIAL_CROPS = 1
            ds = str(cfg.TEST.DATASET)
            if "kinetics" in ds or "epickitchen" in ds:
                cfg.TEST.NUM_SPATIAL_CROPS = 3
            if "imagenet" in ds and not cfg.PRETRAIN.ENABLE:
                cfg.TEST.NUM_ENSEMBLE_VIEWS = 1
                cfg.TEST.NUM_SPATIAL_CROPS = 3
            if "ssv2" in ds:
                cfg.TEST.NUM_ENSEMBLE_VIEWS = 3
                cfg.TEST.NUM_SPATIAL_CROPS = 1
            if cfg.TEST.OVERRIDE_MULTI_SCALE_TEST.ENABLE:
                cfg.TEST.NUM_ENSEMBLE_VIEWS = (
                    cfg.TEST.OVERRIDE_MULTI_SCALE_TEST.NUM_ENSEMBLE_VIEWS)
                cfg.TEST.NUM_SPATIAL_CROPS = (
                    cfg.TEST.OVERRIDE_MULTI_SCALE_TEST.NUM_SPATIAL_CROPS)
            cfg.TEST.LOG_FILE = "val_{}clipsx{}crops.log".format(
                cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS)
            run_list.append([cfg.deep_copy(), test])
    if cfg.SUBMISSION.ENABLE:
        cfg.LOG_MODEL_INFO = False
        cfg.TEST.NUM_ENSEMBLE_VIEWS = 10
        cfg.TEST.NUM_SPATIAL_CROPS = 3
        cfg.TEST.LOG_FILE = "test_{}clipsx{}crops.log".format(
            cfg.TEST.NUM_ENSEMBLE_VIEWS, cfg.TEST.NUM_SPATIAL_CROPS)
        run_list.append([cfg.deep_copy(), submission_test])
    return run_list


def main(argv=None):
    """Run the run list of a command line in every rank; returns each
    task's result in order (training's final ``TrainState``, each test's
    meter) where the list ran in this process, else None."""
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = load_from_args(argv)
    results = launch.launch_task(cfg, run_list, (argv,), cfg.args.device,
                                 cfg.args.init_method)
    return results[0] if len(results) == 1 else None


def run_list(argv):
    """The run list of ``argv`` in this rank; returns each task's result.
    Rank 0 prints the last line. Spawned ranks return None: their results
    stay in their processes."""
    cfg = load_from_args(argv)
    entries = _prepare_data(cfg)
    os.makedirs(cfg.OUTPUT_DIR, exist_ok=True)
    results = [func(run_cfg, device=cfg.args.device)
               for run_cfg, func in entries]
    if collectives.is_master_proc():
        print(f"Finish running with config: {cfg.args.cfg_file}")
    return results if collectives.get_world_size() == 1 else None


if __name__ == "__main__":
    main()
