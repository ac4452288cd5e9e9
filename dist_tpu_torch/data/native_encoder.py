"""ctypes binding of the port's mp4 writer (``data/videoenc.cpp``): BGR24
frames to MPEG-4 Part 2 in an MP4 container through libavformat and
libavcodec, the encoder behind OpenCV's ``mp4v`` fourcc, so that the
port writes the videos ``cv2.VideoWriter`` writes for the JAX package's
``tools/bench_pipeline.py``.

The library is built at first use with the native decoder's rules
(``data/native_decoder.py::build_shared``: g++, FFmpeg's libraries) into
``dist_tpu_torch/_build/``. Where FFmpeg is absent it does not build:
:class:`VideoWriter` raises and says why, and :func:`status` reports it.
"""

import ctypes
import os
import threading

import numpy as np

from dist_tpu_torch.data.native_decoder import build_shared

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "videoenc.cpp")

_lock = threading.Lock()
_lib = None
_error = None


def _bind(path):
    lib = ctypes.CDLL(path)
    lib.dist_video_writer_open.restype = ctypes.c_void_p
    lib.dist_video_writer_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        ctypes.c_char_p, ctypes.c_int]
    lib.dist_video_writer_write.restype = ctypes.c_int
    lib.dist_video_writer_write.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8)]
    lib.dist_video_writer_close.restype = ctypes.c_int
    lib.dist_video_writer_close.argtypes = [ctypes.c_void_p]
    return lib


def get_lib():
    """The bound library, built on the first call. Raises RuntimeError
    with the reason when it does not build or load (and again on every
    later call, without retrying the build)."""
    global _lib, _error
    with _lock:
        if _lib is None and _error is None:
            try:
                _lib = _bind(build_shared(SRC))
            except (RuntimeError, OSError) as e:
                _error = str(e)
        if _lib is None:
            raise RuntimeError(f"native mp4 writer unavailable: {_error}")
        return _lib


def status():
    """``"native"``, or ``"unavailable: <reason>"``."""
    try:
        get_lib()
    except RuntimeError:
        return f"unavailable: {_error}"
    return "native"


class VideoWriter:
    """``cv2.VideoWriter(path, fourcc("mp4v"), fps, (width, height))``:
    :meth:`write` takes ``(height, width, 3)`` uint8 BGR frames,
    :meth:`release` finishes the file. Width and height must be even."""

    def __init__(self, path, fps, size):
        lib = get_lib()
        self.width, self.height = int(size[0]), int(size[1])
        err = ctypes.create_string_buffer(512)
        handle = lib.dist_video_writer_open(
            os.fspath(path).encode(), self.width, self.height, float(fps),
            err, len(err))
        if not handle:
            raise IOError(f"cannot write {path}: {err.value.decode()}")
        self._lib, self._handle, self.path = lib, handle, path

    def write(self, frame):
        frame = np.ascontiguousarray(frame, np.uint8)
        if frame.shape != (self.height, self.width, 3):
            raise ValueError(f"frame {frame.shape} is not "
                             f"({self.height}, {self.width}, 3)")
        rc = self._lib.dist_video_writer_write(
            self._handle, frame.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
        if rc < 0:
            raise IOError(f"encoding a frame of {self.path} failed ({rc})")

    def release(self):
        if self._handle:
            handle, self._handle = self._handle, None
            rc = self._lib.dist_video_writer_close(handle)
            if rc < 0:
                raise IOError(f"finishing {self.path} failed ({rc})")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.release()
