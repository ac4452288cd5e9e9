"""The port's InferenceEngine against the JAX package's on the tiny
config (ViT-Test), with the JAX engine's weights brought over through
``state_dict_from_jax``: same scores for a 1-clip and a padded 3-clip
request, same top-k."""

import os

import numpy as np
import pytest
import torch

import jax

from dist_tpu.config import load_config as jax_load_config
from dist_tpu.serving.engine import InferenceEngine as JaxInferenceEngine
from dist_tpu_torch.config import load_config
from dist_tpu_torch.models.clip.convert import state_dict_from_jax, to_torch
from dist_tpu_torch.serving.engine import InferenceEngine

CFG = "configs/projects/dist/test/tiny_synth.yaml"
# fp32: the point here is the engine's plumbing (buckets, padding, uint8
# normalisation, label prompts, text features); the bf16 policy is held
# to the JAX package in test_torch_port_model.py
OPTS = ["TRAIN.MIXED_PRECISION", "false"]


@pytest.fixture(scope="module")
def engines(repo_root):
    path = os.path.join(repo_root, CFG)
    jax_engine = JaxInferenceEngine(
        jax_load_config(path, OPTS, make_output_dir=False), batch_size=4)
    engine = InferenceEngine(load_config(path, OPTS, make_output_dir=False),
                             batch_size=4, device="cpu")
    params = jax.device_get(jax_engine.state.variables["params"])
    engine.load_state_dict(to_torch(state_dict_from_jax(params)))
    return jax_engine, engine


@pytest.mark.parametrize("n", [1, 3])
def test_scores_and_topk_match_jax(engines, n):
    jax_engine, engine = engines
    rng = np.random.default_rng(n)
    clips = rng.integers(0, 256, (n, engine.num_frames, engine.crop,
                                  engine.crop, 3), dtype=np.uint8)
    want = jax_engine.predict(clips)
    got = engine.predict(clips)
    assert got.shape == (n, engine.num_classes)
    # softmax scores in fp32; only summation order differs
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert [[c for c, _, _ in row] for row in engine.topk(got, 3)] == \
        [[c for c, _, _ in row] for row in jax_engine.topk(want, 3)]


def test_text_features_match_jax(engines):
    jax_engine, engine = engines
    np.testing.assert_allclose(engine.text_features.numpy(),
                               np.asarray(jax_engine.text_features),
                               atol=1e-5, rtol=0)


def test_buckets_and_bad_requests(engines):
    _, engine = engines
    assert engine.buckets() == [1, 2, 4]
    shape = (engine.num_frames, engine.crop, engine.crop, 3)
    with pytest.raises(ValueError):
        engine.predict(np.zeros((5,) + shape, np.uint8))      # > batch size
    with pytest.raises(ValueError):
        engine.predict(np.zeros((1,) + shape, np.float32))    # not uint8


def test_profile_groups_kernels_and_unions_busy_time():
    from dist_tpu_torch.serving import profile

    names = {
        "void (anonymous namespace)::tc::attention_qkv_tc_kernel<64>(x)":
            "K1 attention (csrc/attention.cu)",
        "void (anonymous namespace)::simt::attention_qkv_kernel<64>(x)":
            "K1 attention (csrc/attention.cu)",
        "void (anonymous namespace)::tc::attention_rows_tc_kernel<64>(x)":
            "K4 attention, nb rows per block (csrc/attention.cu)",
        "void (anonymous namespace)::simt::attention_rows_kernel<32>(x)":
            "K4 attention, nb rows per block (csrc/attention.cu)",
        "void (anonymous namespace)::tc::attention_qkv_wr_kernel<64, 208, false>(x)":
            "K1 attention (csrc/attention.cu)",
        "void (anonymous namespace)::tc::attention_rows_wr_kernel<64, 208>(x)":
            "K4 attention, nb rows per block (csrc/attention.cu)",
        "void (anonymous namespace)::spatial_stage_kernel<float, 6>(x)":
            "K2 TemporalNet (csrc/temporal_net.cu)",
        "void (anonymous namespace)::k3::k3_prepare_kernel<96, true>(x)":
            "K2 TemporalNet (csrc/temporal_net.cu)",
        "void (anonymous namespace)::k3::k3_stage_kernel<96, 4>(x)":
            "K2 TemporalNet (csrc/temporal_net.cu)",
        "void (anonymous namespace)::k3::k3_stage_kernel<96, 5>(x)":
            "K2 TemporalNet (csrc/temporal_net.cu)",
        "void (anonymous namespace)::k3::k3_stage_kernel<96, 1>(x)":
            "K3 TemporalNet backward (csrc/temporal_net.cu)",
        "void (anonymous namespace)::k3::k3_prepare_kernel<96, false>(x)":
            "K3 TemporalNet backward (csrc/temporal_net.cu)",
        "nvjet_tst_192x192_64x4_2x1_v_bz_coopB_bias_TNN": "GEMM (cuBLAS)",
        "sm80_xmma_gemm_bf16bf16_bf16f32_f32_tn_n": "GEMM (cuBLAS)",
        "sm80_xmma_fprop_implicit_gemm_indexed_bf16bf16_bf16f32_f32_nhwckrsc":
            "convolution (cuDNN)",
        "cutlass__5x_cudnn::Kernel<cutlass_tensorop_bf16_s16816fprop_x>":
            "convolution (cuDNN)",
        "Memcpy HtoD (Pageable -> Device)": "copies",
        "void at::native::vectorized_elementwise_kernel<8, sigmoid>(x)":
            "other elementwise/reduction",
    }
    assert {n: profile._group(n) for n in names} == names
    # overlapping and nested intervals count once
    assert profile._busy_us([(5, 7), (0, 2), (1, 3), (6, 6.5)]) == 5
    assert profile._busy_us([]) == 0


def test_entry_points_need_a_card_unless_told(repo_root, monkeypatch):
    """No device argument means the CUDA card; without one they raise."""
    from dist_tpu_torch.models.base.models import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = load_config(os.path.join(repo_root, CFG), make_output_dir=False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(cfg, batch_size=2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
