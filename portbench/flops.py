"""Operations and bytes of the work a cell does, from shapes alone, and the
published peaks of the cards the benchmark runs on.

A model's FLOPs count its convolutions and dense layers, two per
multiply-add; bias adds, activations and pools are left out. The backward
pass of a layer computes its weights' gradient (two per multiply-add) and,
but for the first layer, its input's (two more). An env step of the Anakin
IMPALA learner costs one actor forward, then the learner's forward and
backward over ``T + 1`` frames for every ``T`` steps (the bootstrap frame
runs with the fragment); recomputation under remat is not counted.
"""

from __future__ import annotations

# Dense rates without sparsity and HBM bandwidth, from NVIDIA's data sheet
# for the H100 SXM part at its 700 W limit.
PEAKS = {
    "H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12},
}


def peaks(device_name: str) -> dict | None:
    """The peaks of the card named ``device_name`` (None for another)."""
    for key, value in PEAKS.items():
        if key in device_name:
            return value
    return None


def forward_flops(layers: list[dict]) -> int:
    return sum(2 * layer["macs"] for layer in layers)


def backward_flops(layers: list[dict]) -> int:
    return sum((4 if layer["input_grad"] else 2) * layer["macs"] for layer in layers)


def flops_per_env_step(layers: list[dict], unroll_len: int) -> float:
    forward = forward_flops(layers)
    learner = forward + backward_flops(layers)
    return forward + learner * (unroll_len + 1) / unroll_len


def vtrace_bytes(T: int, B: int) -> int:
    """What the fused V-trace tail (B1) must move for a ``[T, B]`` fragment:
    five ``[T, B]`` inputs and the ``[B]`` bootstrap read once, three
    ``[T, B]`` outputs written once, in float32."""
    return 4 * (8 * T * B + B)
