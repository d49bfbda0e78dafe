"""The weights of a run, made on the device from the seed: one normal draw
for every parameter at once, scaled leaf by leaf to the spread the plain
reference's ``param_specs`` gives, in float32 (the type the system keeps
its parameters in). Both sides get the same tensors."""

from __future__ import annotations

import math

import torch


def make(specs: dict, seed: int, device) -> dict[str, torch.Tensor]:
    sizes = [math.prod(shape) for shape, _ in specs.values()]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    stds = torch.tensor([std for _, std in specs.values()], device=device)
    flat *= torch.repeat_interleave(stds, torch.tensor(sizes, device=device))
    return {name: part.view(shape) for (name, (shape, _)), part
            in zip(specs.items(), torch.split(flat, sizes))}
