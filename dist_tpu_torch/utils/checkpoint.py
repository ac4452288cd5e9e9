"""Checkpoints of the port (port of ``dist_tpu/utils/checkpoint.py``).

- Save ``{epoch, step, model_state, optimizer_state, ema}`` per
  checkpoint epoch as one ``torch.save`` file,
  ``OUTPUT_DIR/checkpoints/checkpoint_epoch_{epoch:05d}.pyth``; a
  mid-epoch (preemption) save adds ``_iter_{k:07d}`` to the name and
  ``iter`` and ``loader_sig`` to the payload. The file is written under a
  temporary name and renamed, so it is there whole or not at all.
- Auto-resume from the latest one, or a fine-tune init from
  ``TRAIN.CHECKPOINT_FILE_PATH`` (``load_train_checkpoint``); the test
  priority TEST.CHECKPOINT_FILE_PATH > last > TRAIN's
  (``load_test_checkpoint``).
- Retention (``TRAIN.CHECKPOINT_KEEP_LAST``) and asynchronous saves
  (``TRAIN.CHECKPOINT_ASYNC``: the state is copied to host memory on the
  caller's thread and written on one background thread).
- In a data-parallel group every rank holds the same state: rank 0 alone
  writes and prunes, and the ranks meet at a barrier before any reads.

Orbax checkpoints written by the JAX package (directories under
``OUTPUT_DIR/checkpoints``) are not read by the port, which cannot import
``orbax``; meeting only those is an error that says how to convert them,
never a silent start from scratch. A JAX-trained tree reaches the port
through ``models/clip/convert.py::state_dict_from_jax`` and a ``.pyth``
file.
"""

import functools
import os
import pickle
import re
from concurrent.futures import ThreadPoolExecutor

import torch

from dist_tpu_torch.parallel import collectives, shards
from dist_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_ORBAX_TODO = ("the port does not read the JAX package's Orbax checkpoints "
               "and writes its own as .pyth files; to bring a JAX "
               "TrainState across, restore it with the JAX package, "
               "convert its params with "
               "dist_tpu_torch.models.clip.convert.state_dict_from_jax, "
               "torch.save the result as a .pyth and point "
               "TRAIN.CHECKPOINT_FILE_PATH or TEST.CHECKPOINT_FILE_PATH at "
               "it (python -m dist_tpu_torch.tools.convert_checkpoint "
               "converts released reference .pyth files, not Orbax ones)")
_NAME = re.compile(r"checkpoint_epoch_(\d+)(?:_iter_(\d+))?(\.pyth)?$")
_SIDECAR = ".config.yaml"


def checkpoint_dir(cfg):
    return os.path.join(cfg.OUTPUT_DIR, "checkpoints")


def make_checkpoint_dir(output_dir):
    os.makedirs(os.path.join(output_dir, "checkpoints"), exist_ok=True)


def _ckpt_path(cfg, epoch, iter_in_epoch=None):
    name = f"checkpoint_epoch_{epoch:05d}"
    if iter_in_epoch is not None:
        # mid-epoch (preemption) checkpoint: epoch E iter K sorts after the
        # start-of-E checkpoint and before end-of-E (named E + folds)
        name += f"_iter_{iter_in_epoch:07d}"
    return os.path.abspath(os.path.join(checkpoint_dir(cfg), name + ".pyth"))


def _list_checkpoints(cfg, orbax=False):
    """Committed port checkpoints (``.pyth`` files) under
    OUTPUT_DIR/checkpoints, oldest first by the (epoch, iter) in their
    names; with ``orbax``, the JAX package's checkpoint directories
    instead. A write in flight has a temporary name that matches
    neither."""
    d = checkpoint_dir(cfg)
    if not os.path.isdir(d):
        return []
    found = []
    for n in os.listdir(d):
        m = _NAME.match(n)
        if m is None or bool(m[3]) == orbax:
            continue
        if orbax != os.path.isdir(os.path.join(d, n)):
            continue
        found.append(((int(m[1]), int(m[2] or 0)), n))
    return [n for _, n in sorted(found)]


def get_last_checkpoint(cfg):
    """Latest port checkpoint under OUTPUT_DIR/checkpoints, or None.
    Raises where the directory holds only the JAX package's Orbax
    checkpoints."""
    names = _list_checkpoints(cfg)
    if names:
        return os.path.abspath(os.path.join(checkpoint_dir(cfg), names[-1]))
    orbax = _list_checkpoints(cfg, orbax=True)
    if orbax:
        raise NotImplementedError(
            f"{os.path.join(checkpoint_dir(cfg), orbax[-1])}: {_ORBAX_TODO}")
    return None


def prune_old_checkpoints(cfg):
    """Keep only the newest ``TRAIN.CHECKPOINT_KEEP_LAST`` committed
    checkpoints (-1/0: keep all, the default and the reference's only
    behaviour). Only committed files are candidates; the caller sequences
    the call so that the durable count never drops below ``keep``: a sync
    save prunes after its commit, an async one before it is issued.
    Sidecars whose checkpoint is gone are swept too."""
    keep = int(cfg.TRAIN.get("CHECKPOINT_KEEP_LAST", -1) or -1)
    if keep <= 0:
        return
    d = checkpoint_dir(cfg)
    for name in _list_checkpoints(cfg)[:-keep]:
        path = os.path.join(d, name)
        try:
            os.remove(path)
            if os.path.exists(path + _SIDECAR):
                os.remove(path + _SIDECAR)
            logger.info("Pruned old checkpoint %s (KEEP_LAST=%d)", path, keep)
        except OSError as e:  # never fail training over retention
            logger.warning("Could not prune %s: %s", path, e)
    # an async save that died before its commit leaves a sidecar (written
    # at issue time) with no checkpoint; nothing above would remove it
    try:
        for f in os.listdir(d):
            if f.endswith(_SIDECAR) and not os.path.exists(
                    os.path.join(d, f[:-len(_SIDECAR)])):
                os.remove(os.path.join(d, f))
                logger.info("Removed orphan config sidecar %s", f)
    except OSError as e:
        logger.warning("Could not sweep orphan sidecars in %s: %s", d, e)


def _loader_signature(cfg, dataset_len=-1):
    """What each rank's batch stream is a function of: a mid-epoch
    checkpoint's iter resumes correctly only when these match at restore
    (seed, per-rank batch, process count, folds, dataset length), as the
    JAX package's signature: one rank is one process, so its batch is
    ``TRAIN.BATCH_SIZE`` and the count the world (under the model or pipe
    axis a data shard's ranks read the same batches, and a resume at
    another layout replays the fold-epoch from iter 0). ``dataset_len`` is -1
    where the caller has no loader in hand."""
    return [int(cfg.RANDOM_SEED), int(cfg.TRAIN.BATCH_SIZE),
            collectives.get_world_size(), int(cfg.TRAIN.get("NUM_FOLDS", 1)),
            int(dataset_len)]


def is_checkpoint_epoch(cfg, cur_epoch):
    """Checkpoint cadence, with the saves densified near the end."""
    period = int(cfg.TRAIN.CHECKPOINT_PERIOD)
    max_epoch = int(cfg.OPTIMIZER.MAX_EPOCH)
    folds = int(cfg.TRAIN.get("NUM_FOLDS", 1))
    next_epoch = cur_epoch + folds
    return (next_epoch % period < folds) or (next_epoch >= max_epoch)


class _Writer:
    """One background thread that commits checkpoints in the order they
    were issued; ``wait`` joins the one in flight and raises its error."""

    def __init__(self):
        self._pool = None
        self._pending = None

    def submit(self, fn, *args):
        self.wait()
        if self._pool is None:
            self._pool = ThreadPoolExecutor(1, thread_name_prefix="ckpt")
        self._pending = self._pool.submit(fn, *args)

    def wait(self):
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()


_WRITER = _Writer()


def wait_until_finished():
    """Block until an in-flight async checkpoint save has committed (on
    every rank: a barrier follows rank 0's wait). Call before the process
    exits (train end, preemption): an uncommitted save is invisible to
    ``get_last_checkpoint``, so nothing is corrupted, but the work is
    lost."""
    _WRITER.wait()
    collectives.synchronize()


def _to_host(obj):
    """A copy of ``obj`` with every tensor copied to host memory."""
    if torch.is_tensor(obj):
        return obj.detach().to("cpu", copy=True)
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _commit(payload, path):
    """Write ``payload`` to a temporary name beside ``path``, then rename
    it to ``path``."""
    tmp = os.path.join(os.path.dirname(path),
                       f".{os.path.basename(path)}.tmp-{os.getpid()}")
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def save_checkpoint(cfg, state, cur_epoch, iter_in_epoch=None,
                    dataset_len=-1):
    """Save ``state`` (a ``tasks.state.TrainState``) under
    OUTPUT_DIR/checkpoints; returns the path.

    The stored ``epoch`` is the NEXT fold-epoch's start (``cur_epoch +
    NUM_FOLDS``): one fold-epoch covers NUM_FOLDS data epochs. With
    ``iter_in_epoch`` (the preemption path) it is a mid-epoch save: the
    stored epoch is the current, unfinished fold-epoch and ``iter`` the
    batches of it already consumed, which a resume skips.

    ``TRAIN.CHECKPOINT_ASYNC``: the state is copied to host memory here,
    so the caller may go on changing it, and written on a background
    thread; the next save, or ``wait_until_finished``, joins it.

    Every rank of a group calls in; rank 0 writes, then all meet at a
    barrier, so a synchronous save is committed when any rank returns.
    A sharded state (``TPU.FSDP``, the model axis, a pipe stage's blocks,
    or ``TPU.FSDP`` with either axis) is gathered to full tensors first,
    on every rank (``parallel/shards.py``): the file is the replicated
    run's."""
    async_save = bool(cfg.TRAIN.get("CHECKPOINT_ASYNC", False))
    if iter_in_epoch is None:
        epoch = cur_epoch + int(cfg.TRAIN.get("NUM_FOLDS", 1))
        path = _ckpt_path(cfg, epoch)
    else:
        epoch = cur_epoch
        path = _ckpt_path(cfg, epoch, iter_in_epoch)
    module = state.model.module
    sharded = shards.is_sharded(module)
    if sharded:
        # every rank gathers the full tensors (collective); rank 0 writes
        model_state = shards.full_state_dict(module)
        optimizer_state = shards.full_optimizer_state(module, state.optimizer)
        ema = (shards.full_state_dict(module, state.ema)
               if state.ema is not None else None)
    if not collectives.is_master_proc():
        collectives.synchronize()
        return path
    if not sharded:
        model_state = module.state_dict()
        optimizer_state = state.optimizer.state_dict()
        ema = state.ema
    make_checkpoint_dir(cfg.OUTPUT_DIR)
    payload = {"epoch": int(epoch), "step": int(state.step),
               "model_state": model_state,
               "optimizer_state": optimizer_state}
    if iter_in_epoch is not None:
        payload["iter"] = int(iter_in_epoch)
        payload["loader_sig"] = _loader_signature(cfg, dataset_len)
    if ema is not None:
        payload["ema"] = ema
    payload = _to_host(payload)
    if async_save:
        # retention before the save is issued: only committed files are
        # candidates, so the durable count never drops below KEEP_LAST
        # while this save is in flight
        _WRITER.wait()
        prune_old_checkpoints(cfg)
        _write_config_sidecar(cfg, path)
        _WRITER.submit(_commit, payload, path)
    else:
        _commit(payload, path)
        _write_config_sidecar(cfg, path)
        prune_old_checkpoints(cfg)
    logger.info("Saved checkpoint %s%s", path, " (async)" if async_save else "")
    collectives.synchronize()
    return path


def _write_config_sidecar(cfg, ckpt_path):
    """The full resolved config beside the checkpoint, as
    ``<name>.pyth.config.yaml`` (JSON, which YAML reads); retention
    removes it with its checkpoint."""
    try:
        with open(ckpt_path + _SIDECAR, "w") as f:
            f.write(cfg.dump())
    except OSError as e:  # provenance must never fail a save
        logger.warning("Could not write config sidecar for %s: %s",
                       ckpt_path, e)


def _is_torch_ckpt(path):
    return path.endswith((".pyth", ".pt", ".pth"))


def _pop_heads(sd):
    """Drop head entries (the reference's POP_HEAD), so that a fine-tune
    keeps the fresh head."""
    return {k: v for k, v in sd.items() if "head" not in k}


def preprocess_loaded(cfg, loaded, template):
    """Checkpoint adaptation before the load, behind the reference's
    gates: ``TRAIN.CHECKPOINT_PRE_PROCESS.ENABLE`` drives POP_HEAD (with
    ``FINE_TUNE``) and the pos-embed and patch-embed adaptation,
    ``TRAIN.CHECKPOINT_INFLATE`` the 2D -> 3D inflation against the
    model's ``template`` state dict."""
    from dist_tpu_torch.utils import ckpt_preprocess

    pp = cfg.TRAIN.get("CHECKPOINT_PRE_PROCESS")
    if pp and pp.get("ENABLE"):
        logger.info("Preprocessing given checkpoint.")
        if cfg.TRAIN.get("FINE_TUNE") and pp.get("POP_HEAD"):
            logger.info("Popping heads.")
            loaded = _pop_heads(loaded)
        loaded = ckpt_preprocess.preprocess_params(cfg, loaded)
    if cfg.TRAIN.get("CHECKPOINT_INFLATE"):
        inflated = ckpt_preprocess.inflate_2d_to_3d(loaded, template)
        loaded = {k: inflated.get(k, v) for k, v in loaded.items()}
    return loaded


def match_state_dict(sd, own):
    """(the entries of ``sd`` whose name and shape ``own`` has, the names
    of ``own`` not taken, the names of ``sd`` not taken): the reference's
    ``load_state_dict(strict=False)`` with shape checks."""
    take = {k: v for k, v in sd.items()
            if k in own and tuple(v.shape) == tuple(own[k].shape)}
    return (take, sorted(set(own) - set(take)), sorted(set(sd) - set(take)))


def load_torch_weights(model, path, cfg=None):
    """Load a torch checkpoint into ``model.module`` where names and shapes
    match (:func:`match_state_dict`), adapted by :func:`preprocess_loaded`
    when ``cfg`` is given; logs what did not match."""
    from dist_tpu_torch.models.clip.convert import load_torch_state_dict

    sd = load_torch_state_dict(path)
    module = model.module
    if shards.is_sharded(module):
        own = {k: torch.empty(v, device="meta")
               for k, v in shards.global_shapes(module).items()}
        load = functools.partial(shards.load_state_dict, module)
    else:
        own, load = module.state_dict(), module.load_state_dict
    if cfg is not None:
        sd = preprocess_loaded(cfg, sd, own)
    take, missing, unexpected = match_state_dict(sd, own)
    load(take, strict=False)
    if missing:
        logger.info("Keys in model not matched: %s", missing[:20])
    if unexpected:
        logger.info("Keys in checkpoint not matched: %s", unexpected[:20])
    return model


def _ema_copy(model):
    return {k: v.detach().clone() for k, v in model.module.state_dict().items()}


def load_train_checkpoint(cfg, state, dataset_len=-1):
    """Auto-resume or fine-tune init of ``state`` (in place). Returns
    (state, start_epoch, start_iter): ``start_iter`` > 0 only when
    resuming a mid-epoch (preemption) checkpoint, whose first
    ``start_iter`` batches of fold-epoch ``start_epoch`` the loader must
    skip."""
    last = get_last_checkpoint(cfg) if cfg.TRAIN.AUTO_RESUME else None
    if last:
        logger.info("Auto-resume from %s", last)
        return _resume(cfg, state, last, dataset_len)
    ckpt = cfg.TRAIN.CHECKPOINT_FILE_PATH
    if ckpt:
        if cfg.TRAIN.CHECKPOINT_TYPE == "caffe2":
            raise ValueError("caffe2 checkpoints are not supported; set "
                             "TRAIN.CHECKPOINT_TYPE to 'pytorch'")
        if not (_is_torch_ckpt(ckpt) or cfg.TRAIN.CHECKPOINT_TYPE == "pytorch"):
            raise NotImplementedError(f"{ckpt}: {_ORBAX_TODO}")
        load_torch_weights(state.model, ckpt, cfg)
        if state.ema is not None:
            # the EMA restarts from the loaded weights, as a fresh EMA does
            state.ema = _ema_copy(state.model)
        logger.info("Fine-tune init from %s (epoch reset)", ckpt)
    return state, 0, 0


def _resume(cfg, state, path, dataset_len):
    """Restore ``state`` from the port checkpoint at ``path``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    module = state.model.module
    if shards.is_sharded(module):
        shards.load_state_dict(module, blob["model_state"])
        shards.load_optimizer_state(module, state.optimizer,
                                    blob["optimizer_state"])
    else:
        module.load_state_dict(blob["model_state"])
        state.optimizer.load_state_dict(blob["optimizer_state"])
    state.step = int(blob["step"])
    if state.ema is not None:
        if "ema" in blob:
            # laid out as the module (a pipe rank keeps its stage's blocks)
            device = state.model.device
            state.ema = shards.local_state_dict(
                module, {k: v.to(device) for k, v in blob["ema"].items()})
        else:
            # MODEL.EMA switched on since the save: the EMA restarts from
            # the restored weights, as a fresh EMA does
            logger.warning("Checkpoint %s has no EMA state but EMA is "
                           "enabled; EMA restarts from the restored "
                           "weights.", path)
            state.ema = _ema_copy(state.model)
    elif "ema" in blob:
        logger.warning("Checkpoint %s carries EMA state but EMA is "
                       "disabled; dropping it.", path)
    start_iter = int(blob.get("iter", 0))
    if start_iter:
        saved = list(blob["loader_sig"])
        want = _loader_signature(cfg, dataset_len)
        if saved != want:
            # the recorded iter indexes another batch stream now: replaying
            # the fold-epoch from iter 0 only repeats its prefix
            logger.warning(
                "Mid-epoch resume: loader geometry changed since the "
                "preemption save ([seed, batch, processes, folds, dataset "
                "length] %s -> %s); restarting fold-epoch %d from iter 0 "
                "instead of skipping %d batches.", saved, want,
                int(blob["epoch"]), start_iter)
            start_iter = 0
    return state, int(blob["epoch"]), start_iter


def load_test_checkpoint(cfg, model):
    """Priority TEST.CHECKPOINT_FILE_PATH > last checkpoint >
    TRAIN.CHECKPOINT_FILE_PATH; random weights when none is configured."""
    def candidates():
        # the last checkpoint is looked for only when the first fails
        yield cfg.TEST.CHECKPOINT_FILE_PATH
        yield get_last_checkpoint(cfg)
        yield cfg.TRAIN.CHECKPOINT_FILE_PATH

    for path in candidates():
        if not path:
            continue
        if not _is_torch_ckpt(path):
            raise NotImplementedError(f"{path}: {_ORBAX_TODO}")
        try:
            load_torch_weights(model, path)
        except (OSError, RuntimeError, pickle.UnpicklingError) as e:
            # a corrupt or mismatched file falls through to the next one
            logger.warning("could not load torch checkpoint %s (%s)", path, e)
            continue
        logger.info("Loaded test checkpoint %s", path)
        return model
    logger.warning("Testing with random initialization (no checkpoint found).")
    return model
