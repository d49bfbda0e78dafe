"""Learning parity of ``cartpole_a3c`` at its full budget: the JAX package's
reference numbers, and the port's on the CPU.

    JAX_PLATFORMS=cpu python tests/cartpole_a3c_parity.py [jax|port] [seeds]

trains the preset (64 envs, T=32, 400,000 env steps) at each seed (default
0,1,2) and prints, per seed and as a mean, the 32-episode greedy eval at
``max_steps=500`` that ``chip_smoke.py``'s learning line takes on the GPU
(the eval's own seed is the trainers' default, 1234). It is a script, not a
test: the two packages draw different random numbers, so a single seed's
eval is not comparable and three seeds take minutes.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

EVAL_EPISODES = 32
EVAL_MAX_STEPS = 500


def main() -> int:
    which = sys.argv[1] if len(sys.argv) > 1 else "jax"
    seeds = [int(s) for s in sys.argv[2].split(",")] if len(sys.argv) > 2 else [0, 1, 2]
    if which == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from asyncrl_tpu import make_agent
        from asyncrl_tpu.configs import presets

        build = lambda seed: make_agent(presets.cartpole_a3c, seed=seed)  # noqa: E731
    elif which == "port":
        import torch

        torch.set_num_threads(1)
        from asyncrl_tpu_torch import make_agent
        from asyncrl_tpu_torch.configs import presets

        build = lambda seed: make_agent(presets.cartpole_a3c, seed=seed, device="cpu")  # noqa: E731
    else:
        print(f"unknown package {which!r}; expected jax|port", file=sys.stderr)
        return 2
    evals = []
    for seed in seeds:
        t = time.perf_counter()
        agent = build(seed)
        history = agent.train()
        ret = agent.evaluate(num_episodes=EVAL_EPISODES, max_steps=EVAL_MAX_STEPS)
        evals.append(ret)
        print(json.dumps({"package": which, "seed": seed, "eval_return": ret,
                          "last_window_return": history[-1]["episode_return"],
                          "env_steps": agent.env_steps,
                          "seconds": time.perf_counter() - t}), flush=True)
    print(json.dumps({"package": which, "seeds": seeds, "evals": evals,
                      "mean": sum(evals) / len(evals)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
