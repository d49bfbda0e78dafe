"""The IMPALA deep torso (Espeholt et al. 2018, arXiv:1802.01561, Fig. 3
right) over ``[N, H, W, C]`` stacked frames: stages of a 3x3 conv, a 3x3/2
max pool with SAME padding and two residual blocks (relu, conv, relu, conv,
add), one a channel count of the configuration's ``program.channels``; then
relu, flatten in H, W, C order, Dense of ``widths.features`` and relu; then
the policy and value heads."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import actor_critic as ac
from portbench.reference import precision as prec


def _max_pool_same(x: torch.Tensor) -> torch.Tensor:
    top, bottom = prec.same_pads(x.shape[-2], 3, 2)
    left, right = prec.same_pads(x.shape[-1], 3, 2)
    return F.max_pool2d(F.pad(x, (left, right, top, bottom), value=-float("inf")), 3, 2)


class Net:
    def __init__(self, config: dict):
        self.obs_shape = tuple(config["obs_shape"])
        self.channels = tuple(config["program"]["channels"])
        self.features = config["widths"]["features"]

    def _stage_sizes(self) -> list[tuple[int, int]]:
        """(conv size, pooled size) of each stage."""
        size, out = self.obs_shape[0], []
        for _ in self.channels:
            pooled = -(-size // 2)
            out.append((size, pooled))
            size = pooled
        return out

    def _flat(self) -> int:
        side = self._stage_sizes()[-1][1]
        return side * side * self.channels[-1]

    def param_specs(self, num_actions: int) -> dict:
        specs, cin = {}, self.obs_shape[2]
        for i, ch in enumerate(self.channels):
            specs.update(ac.conv_specs(f"torso.convs.{i}", cin, ch, 3))
            cin = ch
        for i, ch in enumerate(c for c in self.channels for _ in range(2)):
            specs.update(ac.conv_specs(f"torso.blocks.{i}.conv0", ch, ch, 3))
            specs.update(ac.conv_specs(f"torso.blocks.{i}.conv1", ch, ch, 3))
        specs.update(ac.dense_specs("torso.dense", self._flat(), self.features, 2 ** 0.5))
        specs.update(ac.head_specs(self.features, num_actions))
        return specs

    def layers(self, num_actions: int) -> list[dict]:
        out, cin = [], self.obs_shape[2]
        for i, (ch, (size, pooled)) in enumerate(zip(self.channels, self._stage_sizes())):
            out.append(ac.conv_layer(f"convs.{i}", cin, ch, 3, size, size, first=i == 0))
            for j in (2 * i, 2 * i + 1):
                for k in (0, 1):
                    out.append(ac.conv_layer(f"blocks.{j}.conv{k}", ch, ch, 3, pooled, pooled))
            cin = ch
        out.append(ac.dense_layer("dense", self._flat(), self.features))
        return out + ac.head_layers(self.features, num_actions)

    def forward(self, w: dict, obs: torch.Tensor, precision: str = "f32"):
        x = obs.permute(0, 3, 1, 2).to(torch.float32)

        def conv(name, x):
            return prec.conv(x, w[f"{name}.weight"], w[f"{name}.bias"], 1, (1, 1, 1, 1),
                             precision)

        for i in range(len(self.channels)):
            x = _max_pool_same(conv(f"torso.convs.{i}", x))
            for j in (2 * i, 2 * i + 1):
                y = conv(f"torso.blocks.{j}.conv0", F.relu(x))
                x = x + conv(f"torso.blocks.{j}.conv1", F.relu(y))
        h = F.relu(x).permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        h = F.relu(prec.torso_dense(h, w["torso.dense.weight"], w["torso.dense.bias"], precision))
        return ac.heads(w, h, precision)
