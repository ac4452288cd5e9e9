"""Object-store IO (port of ``dist_tpu/utils/bucket.py``).

The same surface as the JAX package's: read to a buffer with
exponential-backoff retries, upload, a local copy of a model file, and
the resolution of a possibly remote path, with the same retry counts and
delays. The JAX package reads through ``tf.io.gfile``; the card's machine
has no TensorFlow, so the port reads local paths and ``file://`` URLs
itself, and any other scheme (``gs://``, ``oss://``, ...) raises
``NotImplementedError`` naming it. No module of the port calls this one,
as none of the JAX package calls its twin.
"""

import io
import os
import shutil
import tempfile
import time

from dist_tpu_torch.utils import logging

logger = logging.get_logger(__name__)

_SCHEMES = ("file",)


def local_path(path):
    """The local file ``path`` names: itself, or a ``file://`` URL's path.
    Raises NotImplementedError for any other scheme."""
    if "://" not in path:
        return path
    scheme, rest = path.split("://", 1)
    if scheme not in _SCHEMES:
        raise NotImplementedError(
            f"{scheme}:// paths are not supported: the port reads local "
            "paths and file:// URLs only (the JAX package reaches other "
            "schemes through TensorFlow's gfile, which the card's machine "
            "does not have)")
    return rest


class _LocalFiles:
    """The two calls of ``tf.io.gfile`` the module makes, on local files."""

    @staticmethod
    def GFile(path, mode):
        return open(local_path(path), mode)

    @staticmethod
    def copy(src, dst, overwrite=False):
        dst = local_path(dst)
        if not overwrite and os.path.exists(dst):
            raise FileExistsError(dst)
        shutil.copyfile(local_path(src), dst)


def _gfile():
    return _LocalFiles


def read_from_bucket(path, retries=5, base_delay=0.5):
    """Read the bytes at ``path`` into a buffer, with exponential-backoff
    retries (``base_delay * 2 ** attempt`` seconds between attempts)."""
    local_path(path)                  # an unsupported scheme is no retry
    for attempt in range(retries):
        try:
            with _gfile().GFile(path, "rb") as f:
                return io.BytesIO(f.read())
        except Exception as e:
            if attempt == retries - 1:
                raise
            delay = base_delay * (2 ** attempt)
            logger.warning("read %s failed (%s); retry in %.1fs", path, e,
                           delay)
            time.sleep(delay)


def put_to_bucket(local_file, remote_path, retries=3):
    """Upload a local file to ``remote_path`` (1 s between attempts)."""
    local_path(remote_path)
    for attempt in range(retries):
        try:
            _gfile().copy(local_file, remote_path, overwrite=True)
            logger.info("Uploaded %s -> %s", local_file, remote_path)
            return
        except Exception as e:
            if attempt == retries - 1:
                raise
            logger.warning("upload failed (%s); retrying", e)
            time.sleep(1.0)


def download_model(remote_path, local_dir=None):
    """Fetch a remote model file into ``local_dir`` once (default:
    ``dist_tpu_models`` under the temporary directory); returns the local
    path."""
    if local_dir is None:
        local_dir = os.path.join(tempfile.gettempdir(), "dist_tpu_models")
    os.makedirs(local_dir, exist_ok=True)
    local = os.path.join(local_dir, os.path.basename(remote_path))
    if os.path.exists(local):
        return local
    buf = read_from_bucket(remote_path)
    with open(local, "wb") as f:
        f.write(buf.getvalue())
    return local


def maybe_remote(path):
    """Resolve a possibly remote path to a local file (a local path or a
    ``file://`` URL is returned as it is)."""
    if path and ("://" in path) and not path.startswith("file://"):
        return download_model(path)
    return path
