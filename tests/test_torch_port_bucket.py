"""The port's object-store IO (``dist_tpu_torch/utils/bucket.py``) against
the JAX package's (``dist_tpu/utils/bucket.py``, through ``tf.io.gfile``)
on the same local files: the same bytes, the same attempts and the same
backoff sleeps; and a remote scheme refused by name."""

import os

import pytest

from dist_tpu.utils import bucket as jax_bucket
from dist_tpu_torch.utils import bucket

PAYLOAD = bytes(range(256)) * 64 + b"tail"


def _roundtrip(mod, root, src):
    """read, put, download twice, maybe_remote: what each returned."""
    out = {"read": mod.read_from_bucket(str(src)).read()}
    dst = root / "remote" / "dst.bin"
    os.makedirs(dst.parent, exist_ok=True)
    mod.put_to_bucket(str(src), str(dst))
    out["put"] = dst.read_bytes()
    cache = str(root / "cache")
    local = mod.download_model(str(dst), local_dir=cache)
    with open(local, "rb") as f:
        out["download"] = f.read()
    out["cached"] = mod.download_model(str(dst), local_dir=cache) == local
    out["download_name"] = os.path.relpath(local, cache)
    out["maybe_remote"] = [mod.maybe_remote(p) for p in
                           (str(src), "file://" + str(src), "", None)]
    return out


def test_local_roundtrip_matches_jax(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(PAYLOAD)
    got = _roundtrip(bucket, tmp_path / "port", src)
    want = _roundtrip(jax_bucket, tmp_path / "jax", src)
    assert got == want
    assert got["read"] == PAYLOAD and got["cached"]


def test_file_url_reads_the_same_bytes(tmp_path):
    src = tmp_path / "src.bin"
    src.write_bytes(PAYLOAD)
    url = "file://" + str(src)
    assert bucket.read_from_bucket(url).read() == \
        jax_bucket.read_from_bucket(url).read() == PAYLOAD


def _failing(mod, monkeypatch):
    """Every gfile call of ``mod`` fails; returns (calls, sleeps)."""
    calls, sleeps = [], []

    class _Failing:
        def GFile(self, path, mode):
            calls.append(("GFile", path, mode))
            raise IOError("transient")

        def copy(self, src, dst, overwrite=False):
            calls.append(("copy", src, dst, overwrite))
            raise IOError("transient")

    monkeypatch.setattr(mod, "_gfile", lambda: _Failing())
    monkeypatch.setattr(mod.time, "sleep", sleeps.append)
    return calls, sleeps


@pytest.mark.parametrize("call", [
    lambda m, p: m.read_from_bucket(p),
    lambda m, p: m.read_from_bucket(p, retries=3, base_delay=0.25),
    lambda m, p: m.put_to_bucket(p, p + ".up"),
    lambda m, p: m.put_to_bucket(p, p + ".up", retries=2),
], ids=["read", "read_3_quarter", "put", "put_2"])
def test_retries_and_backoff_match_jax(tmp_path, monkeypatch, call):
    path = str(tmp_path / "nope.bin")
    seen = []
    for mod in (bucket, jax_bucket):
        calls, sleeps = _failing(mod, monkeypatch)
        with pytest.raises(IOError):
            call(mod, path)
        seen.append((calls, sleeps))
    assert seen[0] == seen[1]
    assert len(seen[0][1]) == len(seen[0][0]) - 1 > 0


@pytest.mark.parametrize("scheme", ["gs", "oss", "s3"])
def test_remote_scheme_raises_and_names_it(tmp_path, scheme, monkeypatch):
    sleeps = []
    monkeypatch.setattr(bucket.time, "sleep", sleeps.append)
    url = f"{scheme}://bucket/model.pyth"
    src = tmp_path / "src.bin"
    src.write_bytes(PAYLOAD)
    for call in (lambda: bucket.read_from_bucket(url),
                 lambda: bucket.put_to_bucket(str(src), url),
                 lambda: bucket.maybe_remote(url)):
        with pytest.raises(NotImplementedError, match=f"{scheme}://"):
            call()
    assert sleeps == []                 # refused at once, never retried
