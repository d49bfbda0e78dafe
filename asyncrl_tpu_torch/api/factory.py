"""``make_agent`` of the port (counterpart of ``asyncrl_tpu/api/factory.py``)."""

from __future__ import annotations

from asyncrl_tpu_torch.config import Config


def make_agent(config: Config | None = None, restore: str | None = None, **overrides):
    """Build a Trainer for ``config`` with keyword overrides, e.g.::

        from asyncrl_tpu_torch import make_agent
        from asyncrl_tpu_torch.configs import presets
        agent = make_agent(presets.atari_impala, device="cuda")
        agent.train(total_env_steps=1_000_000)
        ppo = make_agent(presets.brax_ppo, fused_scan="lax", scan_impl="kernel")
        a3c = make_agent(presets.cartpole_a3c, checkpoint_dir="ckpt", checkpoint_every=50)

    ``restore=path`` starts from the latest checkpoint under ``path``,
    read-only (ongoing saves go to ``config.checkpoint_dir``). It runs on
    CUDA unless ``device="cpu"`` is passed, and raises when CUDA is asked
    for and absent.
    """
    from asyncrl_tpu_torch.api.trainer import Trainer

    return Trainer((config or Config()).replace(**overrides), restore=restore)
