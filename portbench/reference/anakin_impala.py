"""The plain IMPALA learner over on-device env batches: ``steps`` updates,
each a ``T``-step fragment of ``B`` envs followed by one V-trace loss, its
gradient, a global-norm clip and an Adam step; the actor's weights are the
learner's as of every ``actor_staleness``-th update.

``run`` works in one of two ways. Given a ``record`` (the system's first
updates, or the control's), it follows the record's actions: it steps its
own envs with them and the random values it draws itself from the seed,
and reads the record only to judge it (the frames, rewards and ends against
its own, each action against its own logits and the Gumbel noise of that
step, the behaviour log-probs against its own). Without a record it acts
itself, sampling its own actions, and returns a record of the same form.
Either way it learns from its own frames under its own weights.

The learner runs in blocks of whole envs (V-trace is a recurrence over each
env's column), so the full batch fits on one card in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import precision as prec

B1, B2 = 0.9, 0.999
BLOCK_ENVS = 64  # envs a block of the learner's forward and backward (33 frames each)
BLOCK_FRAMES = 4096  # frames a block of the actor's forward


def check_settings(program: dict) -> None:
    """Raise unless the configuration asks for the learner this file runs."""
    wanted = {"algo": "impala", "optimizer": "adam", "lr_schedule": "constant",
              "entropy_anneal_steps": 0, "reward_scale": 1.0, "step_cost": 0.0,
              "normalize_obs": False, "normalize_returns": False, "core": "ff",
              "selfplay": False}
    for key, value in wanted.items():
        if program.get(key) != value:
            raise ValueError(f"the plain IMPALA learner runs {key}={value!r}, "
                             f"the configuration asks {program.get(key)!r}")


def gumbel(u: torch.Tensor) -> torch.Tensor:
    return -torch.log(-torch.log(u + 1e-20) + 1e-20)


def vtrace(behaviour_logp, target_logp, rewards, discounts, values, bootstrap, rho_clip,
           c_clip):
    """``(vs, pg_advantages)`` of Espeholt et al. (2018), eq. 1 and sec. 4.2,
    over time-major ``[T, b]`` tensors."""
    rhos = torch.exp(target_logp - behaviour_logp)
    crho = torch.clamp(rhos, max=rho_clip)
    cs = torch.clamp(rhos, max=c_clip)
    v_next = torch.cat([values[1:], bootstrap[None]])
    deltas = crho * (rewards + discounts * v_next - values)
    diff = torch.empty_like(values)
    acc = torch.zeros_like(bootstrap)
    for t in range(values.shape[0] - 1, -1, -1):
        acc = deltas[t] + discounts[t] * cs[t] * acc
        diff[t] = acc
    vs = diff + values
    vs_next = torch.cat([vs[1:], bootstrap[None]])
    return vs, crho * (rewards + discounts * vs_next - values)


def _logits_in_blocks(model, w, obs, precision):
    """Logits of ``obs [N, ...]`` under ``w``, in blocks of frames."""
    with torch.no_grad():
        return torch.cat([model.forward(w, obs[i:i + BLOCK_FRAMES], precision)[0]
                          for i in range(0, obs.shape[0], BLOCK_FRAMES)])


class Adam:
    """Adam with bias-corrected moments and ``eps`` outside the root."""

    def __init__(self, params: dict, lr: float, eps: float):
        self.lr, self.eps, self.count = lr, eps, 0
        self.mu = {k: torch.zeros_like(v) for k, v in params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in params.items()}

    def step(self, params: dict, grads: dict) -> None:
        self.count += 1
        c1, c2 = 1 - B1 ** self.count, 1 - B2 ** self.count
        for k, g in grads.items():
            self.mu[k] = B1 * self.mu[k] + (1 - B1) * g
            self.nu[k] = B2 * self.nu[k] + (1 - B2) * g * g
            params[k] = params[k] - self.lr * (self.mu[k] / c1) / (
                torch.sqrt(self.nu[k] / c2) + self.eps)


def clip_by_global_norm(grads: dict, max_norm: float) -> dict:
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads.values()))
    if norm < max_norm:
        return grads
    return {k: g * (max_norm / norm) for k, g in grads.items()}


def _learn(model, program, params, frag, behaviour_logp, precision):
    """The loss of one fragment (every env's mean) and its gradient."""
    T, B = frag["actions"].shape
    gamma = program["gamma"]
    total = 0.0
    grads = {k: torch.zeros_like(v) for k, v in params.items()}
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    for lo in range(0, B, BLOCK_ENVS):
        hi = min(lo + BLOCK_ENVS, B)
        obs = torch.cat([frag["obs"][:, lo:hi], frag["bootstrap_obs"][None, lo:hi]])
        logits, values = model.forward(leaves, obs.reshape(-1, *obs.shape[2:]), precision)
        logits = logits.reshape(T + 1, hi - lo, -1)[:T]
        values = values.reshape(T + 1, hi - lo)
        logp_all = F.log_softmax(logits, dim=-1)
        target_logp = logp_all.gather(-1, frag["actions"][:, lo:hi, None])[..., 0]
        done = frag["terminated"][:, lo:hi] | frag["truncated"][:, lo:hi]
        with torch.no_grad():
            vs, pg = vtrace(behaviour_logp[:, lo:hi], target_logp, frag["rewards"][:, lo:hi],
                            gamma * (1.0 - done.float()), values[:T], values[T],
                            program["vtrace_rho_clip"], program["vtrace_c_clip"])
        pg_sum = -(target_logp * pg).sum()
        value_sum = 0.5 * torch.square(vs - values[:T]).sum()
        entropy_sum = -(torch.exp(logp_all) * logp_all).sum()
        loss = (pg_sum + program["value_coef"] * value_sum
                - program["entropy_coef"] * entropy_sum) / (T * B)
        for k, g in zip(leaves, torch.autograd.grad(loss, list(leaves.values()))):
            grads[k] += g
        total += float(loss.detach())
    return total, grads


def run(model, env, program: dict, weights: dict, env_seed: int, steps: int, device,
        precision: str = "f32", record: dict | None = None) -> dict:
    """``steps`` updates from ``weights`` and the envs of ``env_seed``.

    Returns ``losses`` (one an update), ``first_grads`` (the clipped
    gradient of the first update, as the optimizer takes it) and
    ``params_after`` (the weights after the last update), on the CPU. With a
    ``record``: also ``env_mismatch`` (frames, rewards and ends that differ
    from the record's), and of each fragment ``action_gaps`` (the widest gap
    by which a recorded action's logit plus noise lies below the best) and
    ``logp_gaps`` (the widest gap between a recorded behaviour log-prob and
    this one). Without:
    ``record``, what this run did, in the form it takes.
    """
    if precision not in prec.PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    check_settings(program)
    T, B = program["unroll_len"], program["num_envs"]
    with prec.no_tf32():
        gen = torch.Generator(device=device).manual_seed(env_seed)
        state = env.init(B, gen, device)
        params = {k: v.detach().to(device, torch.float32).clone() for k, v in weights.items()}
        actor = dict(params)
        adam = Adam(params, program["learning_rate"], program["adam_eps"])
        out = {"losses": [], "fragments": [], "env_mismatch": 0, "action_gaps": [],
               "logp_gaps": []}
        for k in range(steps):
            given = None if record is None else record["fragments"][k]
            frag = {"obs": torch.empty((T, B, *state["frames"].shape[1:]), dtype=torch.uint8,
                                       device=device),
                    "actions": torch.empty((T, B), dtype=torch.int64, device=device),
                    "rewards": torch.empty((T, B), device=device),
                    "terminated": torch.empty((T, B), dtype=torch.bool, device=device),
                    "truncated": torch.empty((T, B), dtype=torch.bool, device=device)}
            noise = []
            behaviour_logp = torch.empty((T, B), device=device)
            mismatch = torch.zeros((), dtype=torch.int64, device=device)
            for t in range(T):
                frag["obs"][t] = state["frames"]
                u = torch.rand((B, env.num_actions), generator=gen, device=device)
                noise.append(u)
                if given is None:
                    with torch.no_grad():
                        logits = model.forward(actor, state["frames"], precision)[0]
                    action = torch.argmax(logits + gumbel(u), dim=-1)
                    behaviour_logp[t] = F.log_softmax(logits, -1).gather(-1, action[:, None])[:, 0]
                else:
                    mismatch += (state["frames"] != given["obs"][t].to(device)).sum()
                    action = given["actions"][t].to(device)
                frag["actions"][t] = action
                draws = env.draw(B, gen, device)
                state, reward, terminated, truncated = env.step(state, action, draws)
                frag["rewards"][t] = reward
                frag["terminated"][t] = terminated
                frag["truncated"][t] = truncated
            frag["bootstrap_obs"] = state["frames"]
            if given is not None:
                mismatch += (state["frames"] != given["bootstrap_obs"].to(device)).sum()
                for key in ("rewards", "terminated", "truncated"):
                    mismatch += (frag[key] != given[key].to(device)).sum()
                logits = _logits_in_blocks(
                    model, actor, frag["obs"].reshape(T * B, *frag["obs"].shape[2:]), precision
                ).reshape(T, B, -1)
                scores = logits + gumbel(torch.stack(noise))
                chosen = scores.gather(-1, frag["actions"][..., None])[..., 0]
                out["action_gaps"].append(float((scores.amax(-1) - chosen).max()))
                behaviour_logp = F.log_softmax(logits, -1).gather(
                    -1, frag["actions"][..., None])[..., 0]
                out["logp_gaps"].append(float(
                    (behaviour_logp - given["behaviour_logp"].to(device)).abs().max()))
                out["env_mismatch"] += int(mismatch)
            loss, grads = _learn(model, program, params, frag, behaviour_logp, precision)
            grads = clip_by_global_norm(grads, program["max_grad_norm"])
            if k == 0:
                out["first_grads"] = {n: g.cpu() for n, g in grads.items()}
            adam.step(params, grads)
            if (k + 1) % program["actor_staleness"] == 0:
                actor = dict(params)
            out["losses"].append(loss)
            if record is None:
                out["fragments"].append(
                    {**{n: v.cpu() for n, v in frag.items()},
                     "behaviour_logp": behaviour_logp.cpu()})
        out["params_after"] = {n: v.cpu() for n, v in params.items()}
    if record is None:
        out["record"] = {"fragments": out.pop("fragments"), "losses": out["losses"],
                         "first_grads": out["first_grads"],
                         "params_after": out["params_after"]}
        for key in ("env_mismatch", "action_gaps", "logp_gaps"):
            del out[key]
    else:
        del out["fragments"]
    return out
