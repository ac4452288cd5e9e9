"""What the data-parallel tests run inside each rank.

``dist_tpu_torch.parallel.launch.launch_task`` starts the ranks with the
``spawn`` method, which imports the function it runs by name; these
functions live here, apart from the test files, so that a rank imports
torch and the port and never JAX. Each returns plain numpy and Python
values, which pickle back to the test."""

import numpy as np
import torch

from dist_tpu_torch.parallel import collectives as C


def collectives_checks():
    """The host collectives at world 2, as ``tests/mp_worker.py`` checks
    the JAX package's; returns this rank's readings."""
    rank = C.get_rank()
    out = {"rank": rank, "world": C.get_world_size(),
           "master": C.is_master_proc()}
    # unequal lengths: rank r gives r + 2 rows
    local = np.arange(rank + 2, dtype=np.int64) + 10 * rank
    rows = np.full((rank + 2, 2), float(rank), np.float32)
    out["gathered"] = C.all_gather_arrays(local, rows)
    out["mean"] = C.all_reduce_mean(float(rank), 3.0)
    out["any_rank1"] = C.any_flag(rank == 1)
    out["any_none"] = C.any_flag(False)
    out["broadcast"] = C.broadcast_from_master(
        np.asarray([42 if rank == 0 else -1]))
    C.synchronize()
    return out


def rank1_fails():
    """Rank 1 raises while rank 0 waits for it at a barrier."""
    if C.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    C.synchronize()


def both_exit():
    """Every rank leaves through ``SystemExit(0)`` after a barrier, as a
    preemption does."""
    C.synchronize()
    raise SystemExit(0)


def _dist_net(module):
    """The dist_net weights of a DiST model; every weight and buffer of
    another (a conv model's running stats included)."""
    out = {k: p.detach().numpy().copy() for k, p in module.named_parameters()
           if k.startswith("dist_net.")}
    return out or {k: v.detach().numpy().copy()
                   for k, v in module.state_dict().items()}


def ddp_step(cfg, weights, batch, steps=1):
    """``steps`` train steps through DDP, rank r on rows [r * b, (r + 1) *
    b) of ``batch`` (b = its rows / world); returns the ranks' mean loss
    per step, the first step's trainable gradients and the weights
    after. Outside a group: the plain step on the whole batch."""
    from dist_tpu_torch.models.base.models import build_model
    from dist_tpu_torch.optim.optimizer import construct_optimizer
    from dist_tpu_torch.parallel.mesh import wrap_ddp
    from dist_tpu_torch.tasks.state import (
        create_train_state,
        ema_decay,
        make_train_step,
    )

    rank, world = C.get_rank(), C.get_world_size()
    model = build_model(cfg, device="cpu")
    model.module.load_state_dict({k: torch.from_numpy(v)
                                  for k, v in weights.items()})
    optimizer, lr_fn = construct_optimizer(cfg, model.module, 4)
    state = create_train_state(model, optimizer, ema_decay(cfg))
    if torch.distributed.is_initialized():
        wrap_ddp(model)
    step = make_train_step(model, cfg, optimizer, lr_fn)
    b = len(batch["labels"]) // world
    rows = slice(rank * b, (rank + 1) * b)
    tb = {"video": torch.from_numpy(batch["video"][rows]),
          "labels": torch.from_numpy(batch["labels"][rows]).long()}
    if "text_features" in batch:
        tb["text_features"] = torch.from_numpy(batch["text_features"])
    losses, grads = [], None
    for _ in range(steps):
        metrics = step(state, tb)
        losses.append(C.all_reduce_mean(float(metrics["loss"]))[0])
        if grads is None:
            grads = {k: p.grad.numpy().copy()
                     for k, p in model.module.named_parameters()
                     if p.requires_grad}
    return {"losses": losses, "grads": grads,
            "weights": _dist_net(model.module)}


class _Records:
    """Meter and loader hooks of one run list in this rank: each train
    step's (top1, top5, loss, lr, clips), each train batch's dataset
    indices, each val epoch's stats, each test meter's ensembled scores,
    the final dist_net weights and how the train entry ended."""

    def __init__(self):
        from dist_tpu_torch.data.builder import Loader
        from dist_tpu_torch.tasks import test as test_task
        from dist_tpu_torch.tasks import train as train_task

        self.steps, self.indices, self.val, self.tests = [], [], [], []
        self.weights, self.exit, self.step = None, None, None
        rec = self

        class Train(train_task.TrainMeter):
            def update_stats(self, top1, top5, loss, lr, mb):
                rec.steps.append((top1, top5, loss, lr, mb))
                super().update_stats(top1, top5, loss, lr, mb)

        class Val(train_task.ValMeter):
            def log_epoch_stats(self, cur_epoch):
                stats = super().log_epoch_stats(cur_epoch)
                rec.val.append(stats)
                return stats

        class Test(test_task.TestMeter):
            def __init__(self, *args, **kw):
                super().__init__(*args, **kw)
                rec.tests.append(self)

        class Recorded(Loader):
            def __iter__(self):
                for batch in super().__iter__():
                    rec.indices.append(np.asarray(batch["index"]).tolist())
                    yield batch

        build_loader, train = train_task.build_loader, train_task.train

        def recorded_build_loader(cfg, split, device=None):
            loader = build_loader(cfg, split, device)
            if split == "train":
                loader.__class__ = Recorded
            return loader

        def recorded_train(cfg, device=None):
            try:
                state = train(cfg, device)
            except SystemExit as e:
                rec.exit = e.code
                raise
            rec.weights = _dist_net(state.model.module)
            rec.step = int(state.step)
            return state

        self.patches = [(train_task, "TrainMeter", Train),
                        (train_task, "ValMeter", Val),
                        (test_task, "TestMeter", Test),
                        (train_task, "build_loader", recorded_build_loader),
                        (train_task, "train", recorded_train)]

    def summary(self):
        return {"steps": self.steps, "indices": self.indices, "val": self.val,
                "tests": [{"video_preds": m.video_preds,
                           "video_labels": m.video_labels,
                           "clip_count": m.clip_count,
                           "num_clips": m.num_clips} for m in self.tests],
                "weights": self.weights, "exit": self.exit, "step": self.step}


def run_lists(*argv_lists):
    """Each run list of ``argv_lists`` in turn through
    ``dist_tpu_torch.run.run_list``, rank r taking ``argvs[r]`` of each
    (per-rank argv: ``TRAIN.PREEMPT_AFTER_ITERS`` on one rank alone); a
    preemption's ``SystemExit`` ends that list and is recorded. Returns
    one summary of ``_Records`` per list."""
    from dist_tpu_torch import run

    out = []
    for argvs in argv_lists:
        rec = _Records()
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in
                 rec.patches]
        for mod, name, value in rec.patches:
            setattr(mod, name, value)
        try:
            run.run_list(argvs[C.get_rank()])
        except SystemExit:
            pass
        finally:
            for mod, name, value in saved:
                setattr(mod, name, value)
        out.append(rec.summary())
    return out


def ddp_steps(step_args):
    """``ddp_step(*args)`` for each of ``step_args``, in one group."""
    return [ddp_step(*a) for a in step_args]


def ssl_head_and_loss(cases):
    """For each (cfg, head weights, pooled features (N, C), views a
    video): the contrastive head in train mode on this rank's rows of the
    features (rank r on videos [r * B / world, (r + 1) * B / world)) and
    the SSL loss, then the backward. Returns per case the loss, the
    head's gradients, the features' gradient (this rank's rows) and the
    running stats after the forward. Outside a group: the whole batch."""
    from dist_tpu_torch.models.base.models import build_head
    from dist_tpu_torch.optim.losses import calculate_loss

    rank, world = C.get_rank(), C.get_world_size()
    out = []
    for cfg, weights, feats, views in cases:
        head = build_head(cfg, feats.shape[1])
        head.load_state_dict({k: torch.from_numpy(v)
                              for k, v in weights.items()})
        head.train()
        rows = feats.shape[0] // world
        x = torch.from_numpy(feats[rank * rows:(rank + 1) * rows].copy())
        x.requires_grad_(True)
        preds, logits = head(x)
        labels = {"self-supervised": {"contrastive": torch.arange(views)
                                      .repeat(rows // views, 1)}}
        loss, _ = calculate_loss(cfg, preds, logits, labels)
        loss.backward()
        out.append({"loss": loss.item(),
                    "grads": {k: p.grad.numpy().copy()
                              for k, p in head.named_parameters()},
                    "feature_grad": x.grad.numpy().copy(),
                    "stats": {k: v.numpy().copy()
                              for k, v in head.state_dict().items()
                              if k.endswith(("running_mean", "running_var"))}})
    return out
