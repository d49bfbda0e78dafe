"""The policy and value heads shared by the plain torsos, and the
description of a layer that the FLOP count reads.

A model module of this folder gives ``Net(config)``, the network at the
widths of a configuration's file (its ``obs_shape``, ``program`` and
``widths``), with ``param_specs(num_actions)`` (parameter name ->
``(shape, std)``; the names are the system's, so the benchmark can hand
both sides one set of weights), ``layers(num_actions)`` (every convolution
and dense layer, in order) and ``forward(weights, obs, precision) ->
(logits [N, A], values [N])``.
"""

from __future__ import annotations

import math

import torch

from portbench.reference import precision as prec

BIAS_STD = 0.01


def dense_specs(prefix: str, fan_in: int, fan_out: int, gain: float) -> dict:
    """A dense layer's weight ``[out, in]``, of the spread of an orthogonal
    init of ``gain`` (``gain / sqrt(fan_in)`` an entry), and its bias."""
    return {f"{prefix}.weight": ((fan_out, fan_in), gain / math.sqrt(fan_in)),
            f"{prefix}.bias": ((fan_out,), BIAS_STD)}


def conv_specs(prefix: str, cin: int, cout: int, kernel: int) -> dict:
    """A convolution's weight ``[out, in, k, k]`` at lecun's spread, and its bias."""
    fan_in = cin * kernel * kernel
    return {f"{prefix}.weight": ((cout, cin, kernel, kernel), 1.0 / math.sqrt(fan_in)),
            f"{prefix}.bias": ((cout,), BIAS_STD)}


def head_specs(features: int, num_actions: int) -> dict:
    return {**dense_specs("policy", features, num_actions, 0.01),
            **dense_specs("value", features, 1, 1.0)}


def conv_layer(name, cin, cout, kernel, h_out, w_out, first=False) -> dict:
    return {"name": name, "macs": cin * cout * kernel * kernel * h_out * w_out,
            "input_grad": not first}


def dense_layer(name, fan_in, fan_out) -> dict:
    return {"name": name, "macs": fan_in * fan_out, "input_grad": True}


def head_layers(features: int, num_actions: int) -> list[dict]:
    return [dense_layer("policy", features, num_actions), dense_layer("value", features, 1)]


def heads(w: dict, h: torch.Tensor, precision: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logits [N, A], values [N])`` of the torso features ``h [N, F]``."""
    logits = prec.head_dense(h, w["policy.weight"], w["policy.bias"], precision)
    values = prec.head_dense(h, w["value.weight"], w["value.bias"], precision)[:, 0]
    return logits, values
