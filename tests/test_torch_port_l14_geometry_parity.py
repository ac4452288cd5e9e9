"""The port's CLIP+DiST at the ViT-L/14 geometry of
``tests/test_l14_geometry_parity.py`` (24 layers x 1024, 16 heads, patch
14, 257 tokens, embed 768, the 24-step ladder; 8 dense / 4 sparse
frames) on its random fp16-quantised weights: the sniffed architecture,
the logits and the 24 per-layer taps against the JAX package and
``tests/torch_golden.py`` on the CPU. Marked ``slow`` as its JAX twin
(tier-1 skips it): ``python -m pytest -m slow
tests/test_torch_port_l14_geometry_parity.py``."""

import pytest

pytestmark = pytest.mark.slow  # heavy: full L/14 geometry on CPU

from tests import test_l14_geometry_parity as twin  # noqa: E402
from tests.test_torch_port_full_geometry_parity import (  # noqa: E402
    assert_logits,
    assert_taps,
    logits_three_ways,
    taps_three_ways,
    weights,
)
from dist_tpu_torch.models.clip.model import sniff_architecture  # noqa: E402


@pytest.fixture(scope="module")
def l14():
    return weights(14, twin.L14_KW, twin.L14_DIST)


def test_port_l14_arch_sniffing(l14):
    """The port recovers the L/14 architecture from the key shapes alone,
    as the JAX converter does."""
    sd, _, jarch, _ = l14
    arch = sniff_architecture(sd)
    for name in ("vision_layers", "vision_width", "vision_heads",
                 "vision_patch_size", "image_resolution", "embed_dim",
                 "transformer_width", "transformer_layers"):
        assert getattr(arch, name) == getattr(jarch, name), name
    assert (arch.vision_layers, arch.vision_width, arch.vision_heads) == (
        24, 1024, 16)


def test_port_l14_geometry_logits_parity(l14):
    """(1, 8, 224, 224, 3) and 8 label texts: within 2e-3 of both
    references (its twin's bar)."""
    sd, params, arch, rng = l14
    assert_logits(*logits_three_ways(sd, params, arch, rng, twin.L14_DIST,
                                     twin.L14_DIST.num_frames), atol=2e-3)


def test_port_l14_geometry_taps_parity(l14):
    """All 24 taps at (2, 257, 1024), the cls feature and the projected
    logits within 1e-3 of both references."""
    sd, params, arch, rng = l14
    assert_taps(taps_three_ways(sd, params, arch, rng, twin.L14_DIST), 24)
