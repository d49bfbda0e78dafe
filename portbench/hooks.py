"""What the benchmark binds on the system's ``Learner`` instance, and only
there: ``collect`` and ``update_once`` shadowed by wrappers that call the
class's own methods and watch what they return. Nothing of the system's
code is changed, and ``unbind`` removes the wrappers."""

from __future__ import annotations

import torch

# The fields of a fragment that the comparison reads, copied to the host.
FRAGMENT_FIELDS = ("obs", "bootstrap_obs", "actions", "behaviour_logp", "rewards",
                   "terminated", "truncated")


def _host_copy(x: torch.Tensor) -> torch.Tensor:
    """A copy on the host that later in-place updates cannot reach (``.cpu()``
    of a CPU tensor is the tensor itself)."""
    return x.detach().to("cpu", copy=True)


class _Bound:
    def __init__(self, learner):
        self.learner = learner
        self._collect = type(learner).collect.__get__(learner)
        self._update_once = type(learner).update_once.__get__(learner)

    def bind(self):
        self.learner.collect = self.collect
        self.learner.update_once = self.update_once
        return self

    def unbind(self) -> None:
        del self.learner.collect
        del self.learner.update_once


class Recorder(_Bound):
    """Keeps, of the first ``n`` updates, each fragment, each loss, the
    first gradient as the optimizer took it (Adam's first moment after one
    step over ``1 - b1``) and the weights after the last."""

    def __init__(self, learner, n: int):
        super().__init__(learner)
        self.n = n
        self.record = {"fragments": [], "losses": []}

    def collect(self, state):
        actor, rollout, stats = self._collect(state)
        if len(self.record["fragments"]) < self.n:
            self.record["fragments"].append(
                {k: _host_copy(getattr(rollout, k)) for k in FRAGMENT_FIELDS})
        return actor, rollout, stats

    def update_once(self, state):
        state, metrics = self._update_once(state)
        done = len(self.record["losses"])
        if done < self.n:
            self.record["losses"].append(float(metrics["loss"]))
            names = [name for name, _ in state.params.named_parameters()]
            if done == 0:
                b1 = self.learner.optimizer.b1
                self.record["first_grads"] = {
                    name: _host_copy(mu / (1 - b1)) for name, mu in zip(names, state.opt_state.mu)}
            if done + 1 == self.n:
                self.record["params_after"] = {
                    name: _host_copy(p) for name, p in state.params.named_parameters()}
        return state, metrics


class Timer(_Bound):
    """CUDA events around every update and its ``collect``: the device's
    time of each, read once the window has closed."""

    def __init__(self, learner):
        super().__init__(learner)
        self.events = []  # (update start, collect start, collect end, update end)

    @staticmethod
    def _event():
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def collect(self, state):
        self.events[-1].append(self._event())
        out = self._collect(state)
        self.events[-1].append(self._event())
        return out

    def update_once(self, state):
        self.events.append([self._event()])
        out = self._update_once(state)
        self.events[-1].append(self._event())
        return out

    def read(self) -> list[tuple[float, float]]:
        """(update ms, collect ms) of each timed update."""
        torch.cuda.synchronize()
        return [(start.elapsed_time(end), c0.elapsed_time(c1))
                for start, c0, c1, end in self.events]


class Labels(_Bound):
    """Names the host's time in a profile: ``portbench.update`` around each
    update, ``portbench.collect`` around its rollout."""

    def collect(self, state):
        with torch.profiler.record_function("portbench.collect"):
            return self._collect(state)

    def update_once(self, state):
        with torch.profiler.record_function("portbench.update"):
            return self._update_once(state)
