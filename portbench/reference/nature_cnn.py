"""The Nature DQN torso (Mnih et al. 2015, Nature 518:529, Methods "Model
architecture") over ``[N, H, W, C]`` stacked frames: the convolutions of
the configuration's ``widths.convs`` (channels, kernel, stride) with relus,
SAME padding (as the system pads them; the paper's are unpadded), flatten
in H, W, C order, Dense of ``widths.features`` and relu; then the policy
and value heads."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import actor_critic as ac
from portbench.reference import precision as prec


class Net:
    def __init__(self, config: dict):
        self.obs_shape = tuple(config["obs_shape"])
        self.convs = [tuple(c) for c in config["widths"]["convs"]]
        self.features = config["widths"]["features"]

    def _geometry(self):
        """(cin, cout, kernel, stride, size in, size out) of each conv."""
        size, cin, out = self.obs_shape[0], self.obs_shape[2], []
        for ch, kernel, stride in self.convs:
            out.append((cin, ch, kernel, stride, size, -(-size // stride)))
            size, cin = -(-size // stride), ch
        return out

    def _flat(self) -> int:
        side = self._geometry()[-1][5]
        return side * side * self.convs[-1][0]

    def param_specs(self, num_actions: int) -> dict:
        specs = {}
        for i, (cin, cout, kernel, _, _, _) in enumerate(self._geometry()):
            specs.update(ac.conv_specs(f"torso.convs.{i}", cin, cout, kernel))
        specs.update(ac.dense_specs("torso.dense", self._flat(), self.features, 2 ** 0.5))
        specs.update(ac.head_specs(self.features, num_actions))
        return specs

    def layers(self, num_actions: int) -> list[dict]:
        out = [ac.conv_layer(f"convs.{i}", cin, cout, kernel, size, size, first=i == 0)
               for i, (cin, cout, kernel, _, _, size) in enumerate(self._geometry())]
        out.append(ac.dense_layer("dense", self._flat(), self.features))
        return out + ac.head_layers(self.features, num_actions)

    def forward(self, w: dict, obs: torch.Tensor, precision: str = "f32"):
        x = obs.permute(0, 3, 1, 2).to(torch.float32)
        for i, (_, _, kernel, stride, size, _) in enumerate(self._geometry()):
            low, high = prec.same_pads(size, kernel, stride)
            x = F.relu(prec.conv(x, w[f"torso.convs.{i}.weight"], w[f"torso.convs.{i}.bias"],
                                 stride, (low, high, low, high), precision))
        h = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        h = F.relu(prec.torso_dense(h, w["torso.dense.weight"], w["torso.dense.bias"],
                                    precision))
        return ac.heads(w, h, precision)
