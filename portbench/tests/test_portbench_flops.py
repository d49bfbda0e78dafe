"""The FLOP and byte counts the readers use, from shapes alone."""

import re

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import cells, flops, weights
from portbench.cells import REPO

OBS = (84, 84, 4)
CONFIGS = {"atari_impala": "atari_impala.b1024", "atari_nature_cnn": "atari_nature_cnn.b1024"}


def net(config: str, **program):
    """The reference's network of a configuration, its program changed by
    ``program``."""
    cell = cells.load(CONFIGS[config])
    return cell.reference_module("model").Net(
        {**cell.config, "program": {**cell.config["program"], **program}})


@pytest.mark.parametrize("config, mflop", [("atari_impala", 108.45), ("atari_nature_cnn", 32.01)])
def test_forward_flops_a_frame(config, mflop):
    assert flops.forward_flops(net(config).layers(6)) / 1e6 == pytest.approx(mflop, abs=0.01)


@pytest.mark.parametrize("config, program", [("atari_impala", {}), ("atari_nature_cnn", {}),
                                             ("atari_impala", {"channels": [32, 64, 64]})])
def test_counts_match_torch_flop_counter(config, program):
    """The layer lists count what PyTorch's counter sees in the reference's
    own forward and backward (one frame, the input needing no gradient), at
    the configuration's widths."""
    model = net(config, **program)
    w = {k: v.requires_grad_(True)
         for k, v in weights.make(model.param_specs(6), 0, "cpu").items()}
    obs = torch.randint(0, 2, (1, *OBS), dtype=torch.uint8)
    with FlopCounterMode(display=False) as forward:
        logits, values = model.forward(w, obs)
    with FlopCounterMode(display=False) as backward:
        (logits.sum() + values.sum()).backward()
    layers = model.layers(6)
    assert forward.get_total_flops() == flops.forward_flops(layers)
    assert backward.get_total_flops() == flops.backward_flops(layers)


def test_flops_per_env_step():
    layers = net("atari_impala").layers(6)
    fwd, bwd = flops.forward_flops(layers), flops.backward_flops(layers)
    assert flops.flops_per_env_step(layers, 32) == pytest.approx(fwd + (fwd + bwd) * 33 / 32)


def test_vtrace_bytes_follow_the_kernel_signature():
    """B1 reads every ``const float*`` of its launch once (all ``[T, B]``
    but the ``[B]`` bootstrap) and writes every ``float*`` output once."""
    source = (REPO / "asyncrl_tpu_torch" / "csrc" / "fused_vtrace.cu").read_text()
    signature = re.search(r'extern "C" int fused_vtrace_launch\((.*?)\)', source, re.S).group(1)
    params = [p.strip() for p in signature.split(",")]
    reads = [p for p in params if p.startswith("const float*")]
    writes = [p for p in params if p.startswith("float*")]
    assert [p.split()[-1] for p in reads][-1] == "boot"
    T, B = 32, 1024
    assert flops.vtrace_bytes(T, B) == 4 * ((len(reads) - 1 + len(writes)) * T * B + B)
    assert flops.vtrace_bytes(T, B) / 3.35e12 * 1e3 == pytest.approx(0.000314, rel=1e-3)


def test_peaks_of_the_card():
    assert flops.peaks("NVIDIA H100 80GB HBM3")["bf16_flops"] == 989e12
    assert flops.peaks("cpu") is None
