"""The port's tools (``dist_tpu_torch/tools``) on the CPU at shrunken sizes
(the tiny config, one repetition): every printed line parses, carries the
keys of the JAX tool it ports and holds no ``error``; ``bench`` prints both
metrics; without ``--device cpu`` and without a card, every tool raises.
The numbers are CPU times and are not checked. This file runs every
microbench command and pins the kernel-source variants; the other tools
are ``test_torch_port_tools_run.py``'s."""

import json
import os

import pytest
import torch

from dist_tpu_torch.tools import (
    attn_variants,
    microbench,
    tnet_bwd,
    tnet_fwd,
)

TINY = "configs/projects/dist/test/tiny_synth.yaml"


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(ln) for ln in out.splitlines() if ln.strip()]


@pytest.fixture
def tiny_microbench(monkeypatch):
    for name, value in {
            "REPS": 1, "OUTER": 1, "BATCH": 1, "CFG": TINY,
            "ATTN": (4, 17, 2, 16), "ATTN_ROWS": (1, 2, 4),
            "GEOMETRY": {"frames": 4, "crop": 32, "patch": 16, "width": 64,
                         "layers": 2, "embed": 32, "alpha": 2},
            "INT8_SHAPES": ((32, 16, 24), (32, 24, 16))}.items():
        monkeypatch.setattr(microbench, name, value)
    # two intra-op threads: the suite runs in several worker processes at
    # once, and every core in each of them would oversubscribe the host
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


# the variants each subcommand prints (the JAX tool's, renamed where the
# port's shipped formulation differs)
VARIANTS = {
    "attn": ["attn_shipped", "attn_plain", "attn_sdpa", "attn_rows1",
             "attn_rows2", "attn_rows4"],
    "stem": ["stem_conv3d", "stem_transpose", "stem_rows",
             "tower_conv1_dense", "tower_conv1_sparse"],
    "conv33": ["conv33_fwd_bwd", "mm33_fwd_bwd"],
    "int8": ["bf16_32x16x24", "int8_32x16x24", "bf16_32x24x16",
             "int8_32x24x16"],
    "dist": ["dist_full", "dist_full_fused", "stem", "temporal_net",
             "integration", "input_linear", "t2i", "i2t", "adapool"],
    "bwd": ["dist_fwd_bwd", "dist_fwd_bwd_fused", "dist_fwd_bwd_remat",
            "dist_fwd_bwd_remat_fused", "fused_vs_unfused_parity",
            "stem_fwd_bwd"],
    "bwd_parts": ["stem_fwd_bwd", "temporal_net_fwd_bwd",
                  "integration_fwd_bwd", "input_linear_fwd_bwd",
                  "t2i_fwd_bwd", "i2t_fwd_bwd", "adapool_fwd_bwd"],
    "train": ["train_step_full", "loss_fwd_only", "loss_fwd_bwd",
              "optimizer_only"],
}
# the variants that report a max |difference| against the shipped one
WITH_DIFF = {"attn_plain", "attn_rows1", "attn_rows2", "attn_rows4",
             "stem_transpose", "stem_rows", "fused_vs_unfused_parity"}


@pytest.mark.parametrize("command", sorted(VARIANTS))
def test_microbench_command(tiny_microbench, capsys, command):
    assert microbench.main([command, "--device", "cpu"]) == 0
    lines = _lines(capsys)
    assert all("error" not in r for r in lines), lines
    if command == "conv33":
        check, lines = lines[0], lines[1:]
        assert check["check"] == "max_abs_diff" and check["v"] >= 0
    assert [r["variant"] for r in lines] == VARIANTS[command]
    for r in lines:
        if r["variant"] == "fused_vs_unfused_parity":
            assert r["max_abs_diff"] <= r["out_max"]
        else:
            assert r["ms"] > 0 and r["first_call_s"] > 0
            assert r["device"] == "cpu"
        assert ("max_abs_diff" in r) == (r["variant"] in WITH_DIFF)


@pytest.mark.parametrize("name", sorted(attn_variants.VARIANTS))
def test_attn_variants_apply_to_the_kernel_source(name):
    """Each variant's substitutions find their anchors in
    ``csrc/attention.cu`` as often as stated, so an edit of the kernel that
    moves one fails here and not on the card."""
    src = attn_variants.variant_source(name)
    with open(os.path.join(attn_variants._build.SRC_DIR, "attention.cu")) as f:
        shipped = f.read()
    assert (src == shipped) == (name == "shipped")
    assert src.count("#if 0") == {"copies_only": 2, "math_only": 1}.get(name, 0)


def test_attn_variants_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs the CUDA card"):
        attn_variants.main([])


@pytest.mark.parametrize("name", sorted(tnet_bwd.VARIANTS))
def test_tnet_bwd_variants_apply_to_the_kernel_source(name):
    """Each K3 variant's substitutions find their anchors in
    ``csrc/temporal_net.cu`` once, and only the bf16 route's lines move."""
    src = attn_variants.variant_source(name, "temporal_net",
                                       tnet_bwd.VARIANTS)
    with open(os.path.join(attn_variants._build.SRC_DIR,
                           "temporal_net.cu")) as f:
        shipped = f.read()
    assert (src == shipped) == (name == "shipped")
    moved = [a for a, b in zip(shipped.splitlines(), src.splitlines())
             if a != b]
    assert len(moved) == len(tnet_bwd.VARIANTS[name])
    assert all("rows_times_weights" in ln or "a_t_b" in ln
               or "cp_async16" in ln for ln in moved)


@pytest.mark.parametrize("mangled,name", [
    ("_ZN12_GLOBAL__N_12k315k3_stage_kernelILi96ELi1EEEvNS0_4ArgsE",
     "k3_stage_kernel<96, B>"),
    ("_ZN12_GLOBAL__N_12k315k3_wgrad_kernelILi128EEEvNS0_4ArgsEi",
     "k3_wgrad_kernel<128>"),
    ("_ZN12_GLOBAL__N_12k313k3_sum_kernelEPKfiNS0_8SegmentsE",
     "k3_sum_kernel"),
    ("_ZN12_GLOBAL__N_12k315k3_stage_kernelILi96ELi4EEEvNS0_4ArgsE",
     "k3_stage_kernel<96, Af>"),
    ("_ZN12_GLOBAL__N_12k315k3_stage_kernelILi32ELi5EEEvNS0_4ArgsE",
     "k3_stage_kernel<32, F>"),
    ("_ZN12_GLOBAL__N_12k317k3_prepare_kernelILi96ELb1EEEvNS0_4ArgsE",
     "k3_prepare_kernel<96, fwd>"),
    ("_ZN12_GLOBAL__N_12k317k3_prepare_kernelILi128ELb0EEEvNS0_4ArgsE",
     "k3_prepare_kernel<128, bwd>"),
    ("_ZN12_GLOBAL__N_114sum_rows_kernelEPKfPfii",
     "_ZN12_GLOBAL__N_114sum_rows_kernelEPKfPfii")])
def test_tnet_bwd_instance_names(mangled, name):
    assert tnet_bwd.instance_name(mangled) == name


@pytest.mark.parametrize("cmd", ["errors", "variants"])
def test_tnet_bwd_needs_a_card(monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs the CUDA card"):
        tnet_bwd.main([cmd])


def test_tnet_bwd_readings_and_control_on_cpu():
    """The readings on the CPU, where the wrapper runs the plain version:
    the kernel's readings are zero and the control's are not, so the
    control breaks any limits."""
    from dist_tpu_torch.ops import temporal_net as tn

    x, g, params = _cpu_inputs()

    got = tn.fused_temporal_net_bwd(x, g, *params)
    assert all(v == {"max_rel": 0.0, "rel_l2": 0.0}
               for v in tnet_bwd.errors(got, tn.temporal_net_bwd_plain(
                   x, g, *params)).values())
    control = tnet_bwd.errors(got, tn.temporal_net_bwd_plain(
        x, g, *tnet_bwd.control_params(params)))
    limits = {n: {"max_rel": 0.0, "rel_l2": 0.0} for n in tnet_bwd.NAMES}
    assert len(tnet_bwd.breaches(control, limits)) >= 12
    assert params[4][0, 0, 0].abs().sum() > 0     # the original unchanged


def _cpu_inputs():
    gen = torch.Generator().manual_seed(0)
    shape, f, k = (1, 4, 5, 6, 16), 8, 3

    def rnd(*s, scale=1.0):
        return torch.randn(s, generator=gen) * scale

    c = shape[-1]
    return (rnd(*shape), rnd(*shape),
            (1.0 + rnd(c, scale=0.1), rnd(c, scale=0.1),
             rnd(k, 1, 1, c, f, scale=(k * c) ** -0.5), rnd(f, scale=0.1),
             rnd(1, 3, 3, f, c, scale=(9 * f) ** -0.5), rnd(c, scale=0.1)))



@pytest.mark.parametrize("cmd", ["errors", "variants", "host"])
def test_tnet_fwd_needs_a_card(monkeypatch, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="needs the CUDA card"):
        tnet_fwd.main([cmd])


@pytest.mark.parametrize("argv,cmd,opts", [
    (["errors"], "errors", {"seeds": 3}),
    (["errors", "--seeds", "1"], "errors", {"seeds": 1}),
    (["variants"], "variants", {"reps": 20}),
    (["variants", "--reps", "5"], "variants", {"reps": 5}),
    (["host"], "host", {"calls": 50}),
    (["host", "--calls", "7"], "host", {"calls": 7})])
def test_tnet_fwd_arguments(monkeypatch, argv, cmd, opts):
    """Each command gets its own options, with their defaults; an unknown
    command or option is refused."""
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tnet_fwd, f"cmd_{cmd}", seen.append)
    tnet_fwd.main(argv)
    assert len(seen) == 1 and seen[0].cmd == cmd
    assert {k: v for k, v in vars(seen[0]).items() if k != "cmd"} == opts
    with pytest.raises(SystemExit):
        tnet_fwd.main([cmd, "--bogus", "1"])


def test_tnet_fwd_readings_and_control_on_cpu():
    """The readings on the CPU, where the wrapper runs the plain version:
    the kernel's reading is zero and within any limits, the control's is
    not, so it breaks them; the instances the kernels line reads are K2's
    three."""
    from dist_tpu_torch.ops import temporal_net as tn

    x, _, params = _cpu_inputs()
    got = tn.fused_temporal_net(x, *params)
    reading = tnet_fwd.errors(got, tn.temporal_net_plain(x, *params))
    assert reading == {"out": {"max_rel": 0.0, "rel_l2": 0.0}}
    assert not tnet_bwd.breaches(reading, tnet_fwd.FWD_BF16_LIMITS)
    control = tnet_fwd.errors(got, tn.temporal_net_plain(
        x, *tnet_bwd.control_params(params)))
    assert [b[:2] for b in tnet_bwd.breaches(
        control, tnet_fwd.FWD_BF16_LIMITS)] == [("out", "max_rel"),
                                                ("out", "rel_l2")]
    assert tnet_fwd.instances(96) == (
        "k3_prepare_kernel<96, fwd>", "k3_stage_kernel<96, Af>",
        "k3_stage_kernel<96, F>")


def test_tnet_fwd_unfused_block_is_the_plain_version():
    """``unfused_ms``'s yardstick computes the block: the model's unfused
    TemporalNet holding the same parameters equals the plain version to
    fp32 summation order (atol 1e-5)."""
    from dist_tpu_torch.ops import temporal_net as tn

    x, _, params = _cpu_inputs()
    with torch.no_grad():
        got = tnet_fwd.unfused_block(params)(x)
    torch.testing.assert_close(got, tn.temporal_net_plain(x, *params),
                               atol=1e-5, rtol=0)
