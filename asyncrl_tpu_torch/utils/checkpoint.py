"""Checkpoint / resume of the port (counterpart of
``asyncrl_tpu/utils/checkpoint.py``), on ``torch.save``.

The FULL ``TrainState`` is saved: the learner and actor weights, the Adam
count and moments, the actor state (env states, observations, running
episode sums), ``update_step`` and the generator's state, with the
trainer's ``env_steps`` in the step's metadata. So the next update after a
restore is bit-identical to the one the run would have taken had it not
stopped (``tests/test_torch_learner.py``).

Each step is a directory ``<dir>/<step>/`` holding ``state.pt`` and
``meta.json``, written under a temporary name and renamed into place, with
a sha256 content-digest manifest ``<dir>/manifest-<step>.json`` beside it
(also written then renamed). A restore whose content disagrees with its
manifest raises :class:`ChecksumMismatch`; restoring the latest step falls
back through older retained steps when one fails, as the JAX package's
does. Writes are synchronous: the JAX package's async orbax writer, its
save retries and its fault-injection sites come with the runtime slice
(``ROADMAP.md``, Queue A item 14).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import math
import os
import shutil
import sys
import traceback
from typing import Any

import torch

STATE_FILE = "state.pt"
META_FILE = "meta.json"


class ChecksumMismatch(ValueError):
    """A restored step's content digest disagrees with its manifest: the
    save was torn or the data corrupted on disk."""


def _flatten(prefix: str, node: Any, out: dict[str, Any]) -> None:
    """Leaves of dataclasses, NamedTuples, lists and tensors, keyed by path."""
    if isinstance(node, torch.Tensor) or node is None or isinstance(node, (int, float)):
        out[prefix] = node
    elif dataclasses.is_dataclass(node):
        for f in dataclasses.fields(node):
            _flatten(f"{prefix}.{f.name}", getattr(node, f.name), out)
    elif isinstance(node, tuple) and hasattr(node, "_fields"):
        for name in node._fields:
            _flatten(f"{prefix}.{name}", getattr(node, name), out)
    elif isinstance(node, (list, tuple)):
        for i, item in enumerate(node):
            _flatten(f"{prefix}.{i}", item, out)
    else:
        raise TypeError(f"cannot checkpoint {prefix} of type {type(node).__name__}")


def state_dict(state) -> dict[str, Any]:
    """A ``TrainState`` as a flat dict of CPU tensors and Python numbers."""
    flat: dict[str, Any] = {}
    for name, module in (("params", state.params), ("actor_params", state.actor_params)):
        for key, value in module.state_dict().items():
            flat[f"{name}.{key}"] = value
    flat["opt.count"] = state.opt_state.count
    _flatten("opt.mu", state.opt_state.mu, flat)
    _flatten("opt.nu", state.opt_state.nu, flat)
    _flatten("actor", state.actor, flat)
    flat["update_step"] = state.update_step
    flat["generator"] = state.generator.get_state()
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else v for k, v in flat.items()}


def load_state_dict(state, flat: dict[str, Any]) -> None:
    """Copy ``flat`` (from :func:`state_dict`) into the live ``state`` in
    place, each tensor onto its live device. A leaf that is missing or of
    another shape or type raises."""
    live: dict[str, Any] = {}
    for name, module in (("params", state.params), ("actor_params", state.actor_params)):
        for key, value in module.state_dict().items():
            live[f"{name}.{key}"] = value
    _flatten("opt.mu", state.opt_state.mu, live)
    _flatten("opt.nu", state.opt_state.nu, live)
    _flatten("actor", state.actor, live)
    expected = set(live) | {"opt.count", "update_step", "generator"}
    if set(flat) != expected:
        raise ValueError(
            f"checkpoint leaves differ from the state's: missing {sorted(expected - set(flat))}, "
            f"unexpected {sorted(set(flat) - expected)}"
        )
    with torch.no_grad():
        for key, target in live.items():
            saved = flat[key]
            if isinstance(target, torch.Tensor):
                if not isinstance(saved, torch.Tensor) or saved.shape != target.shape \
                        or saved.dtype != target.dtype:
                    raise ValueError(f"checkpoint leaf {key} does not match the live state")
                target.copy_(saved)
            elif saved != target:
                raise ValueError(f"checkpoint leaf {key}={saved!r}, live {target!r}")
    state.opt_state.count = int(flat["opt.count"])
    state.update_step = int(flat["update_step"])
    state.generator.set_state(flat["generator"])


def content_digest(flat: dict[str, Any]) -> str:
    """sha256 over a flat state's content: each key, dtype, shape and the
    bytes of each tensor (numbers by their repr), in key order."""
    h = hashlib.sha256()
    for key in sorted(flat):
        value = flat[key]
        h.update(key.encode())
        if isinstance(value, torch.Tensor):
            t = value.detach().cpu().contiguous()
            h.update(str(t.dtype).encode())
            h.update(str(tuple(t.shape)).encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(value).encode())
    return h.hexdigest()


def _write_json(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


class Checkpointer:
    """Saves keyed by ``update_step`` under ``directory``, the newest
    ``max_to_keep`` retained; ``meta`` carries ``env_steps`` and what
    :meth:`set_extra_meta` adds."""

    def __init__(self, directory: str, max_to_keep: int = 3, create: bool = True):
        self.directory = os.path.abspath(directory)
        if not os.path.isdir(self.directory):
            if not create:
                raise FileNotFoundError(f"no checkpoint directory at {self.directory}")
            os.makedirs(self.directory)
        self.max_to_keep = max_to_keep
        self._last_saved: int | None = None
        self._restored_step: int | None = None
        self._extra_meta: dict = {}

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(int(step)))

    def _manifest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"manifest-{int(step)}.json")

    def all_steps(self) -> list[int]:
        return sorted(
            int(name) for name in os.listdir(self.directory)
            if name.isdigit() and os.path.isfile(os.path.join(self.directory, name, STATE_FILE))
        )

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def set_extra_meta(self, **kv) -> None:
        """Metadata carried by later saves, merged with earlier calls'."""
        self._extra_meta.update(kv)

    def read_meta(self, step: int | None = None) -> dict:
        """The metadata of ``step`` (the latest by default), {} if none."""
        if step is None:
            step = self.latest_step()
        if step is None:
            return {}
        with open(os.path.join(self._step_dir(step), META_FILE)) as f:
            return json.load(f)

    def read_manifest(self, step: int) -> dict | None:
        try:
            with open(self._manifest_path(step)) as f:
                return json.load(f)
        except (OSError, json.JSONDecodeError):
            return None

    def save(self, step: int, state, env_steps: int = 0) -> None:
        """Save ``state`` (a ``TrainState``) under ``step``, synchronously.
        Saving the step this checkpointer just saved, or the one it just
        restored, is a no-op (the data is the same by the resume contract);
        a step of that number left by another run is replaced."""
        step = int(step)
        if step == self._last_saved or (step == self._restored_step
                                        and step in self.all_steps()):
            self._last_saved = step
            return
        flat = state_dict(state)
        meta = {"env_steps": int(env_steps), **self._extra_meta}
        final = self._step_dir(step)
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(flat, os.path.join(tmp, STATE_FILE))
        _write_json(os.path.join(tmp, META_FILE), meta)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        _write_json(self._manifest_path(step), {
            "step": step, "sha256": content_digest(flat), "env_steps": int(env_steps),
        })
        self._last_saved = step
        for old in self.all_steps()[:-self.max_to_keep]:
            self.delete_step(old)

    def delete_step(self, step: int) -> None:
        shutil.rmtree(self._step_dir(step), ignore_errors=True)
        try:
            os.remove(self._manifest_path(step))
        except OSError:
            pass  # a step saved without a manifest
        if step == self._last_saved:
            self._last_saved = None

    def restore(self, state, step: int | None = None) -> int:
        """Restore ``step`` (default: the latest, falling back through older
        retained steps when one fails) into the live ``state`` in place;
        returns the saved ``env_steps``."""
        if step is not None:
            return self._restore_step(state, int(step))
        steps = sorted(self.all_steps(), reverse=True)
        if not steps:
            raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        for i, candidate in enumerate(steps):
            try:
                return self._restore_step(state, candidate)
            # lint: broad-except-ok(the latest-step restore falls back through older retained steps; the last failure re-raises)
            except Exception as e:
                if i == len(steps) - 1:
                    raise
                print(
                    f"asyncrl_tpu_torch: checkpoint step {candidate} failed to restore "
                    f"({type(e).__name__}: {e}); falling back to retained step {steps[i + 1]}",
                    file=sys.stderr,
                )
        raise AssertionError("unreachable")

    def _restore_step(self, state, step: int) -> int:
        flat = torch.load(os.path.join(self._step_dir(step), STATE_FILE), weights_only=True)
        manifest = self.read_manifest(step)
        if manifest is not None:
            digest = content_digest(flat)
            if digest != manifest.get("sha256"):
                raise ChecksumMismatch(
                    f"checkpoint step {step} failed its manifest checksum (saved "
                    f"{manifest.get('sha256', '?')[:12]}..., restored {digest[:12]}...): "
                    "torn or corrupted save"
                )
        load_state_dict(state, flat)
        self._restored_step = step
        return int(self.read_meta(step).get("env_steps", 0))


class TrainerCheckpointing:
    """The trainer's checkpoint policy: the periodic cadence, the best-eval
    slot and the end-of-train save. With no ``Checkpointer`` every hook is
    a no-op except ``save_now``, which raises."""

    def __init__(self, checkpointer: Checkpointer | None, every: int,
                 best_dir: str | None = None):
        self.checkpointer = checkpointer
        self.every = every
        self._since = 0
        self._best_dir = best_dir
        self._best: Checkpointer | None = None
        self._best_score: float | None = None

    def save_now(self, state, env_steps: int) -> None:
        if self.checkpointer is None:
            raise RuntimeError("no checkpoint_dir configured; set config.checkpoint_dir")
        self.checkpointer.save(state.update_step, state, env_steps)

    def after_update(self, state, env_steps: int) -> None:
        """The periodic cadence: call once per update call."""
        if self.checkpointer is None or not self.every:
            return
        self._since += 1
        if self._since >= self.every:
            self._since = 0
            self.save_now(state, env_steps)

    def maybe_save_best(self, state, env_steps: int, score: float) -> bool:
        """Save ``state`` to the best slot if ``score`` beats the best so far
        (across resumes too: the score rides the slot's metadata). A score
        that is not finite never qualifies."""
        if self._best_dir is None or not math.isfinite(score):
            return False
        if self._best is None:
            self._best = Checkpointer(self._best_dir, max_to_keep=1)
            prev = self._best.read_meta().get("eval_return")
            self._best_score = float(prev) if prev is not None and math.isfinite(prev) else None
        if self._best_score is not None and score <= self._best_score:
            return False
        self._best_score = float(score)
        self._best.set_extra_meta(eval_return=float(score))
        for stale in self._best.all_steps():
            # A resumed run may be behind the slot's step; the slot keeps
            # the highest step, so the stale one goes first.
            if stale > state.update_step:
                self._best.delete_step(stale)
        self._best.save(state.update_step, state, env_steps)
        return True

    def finalize(self, state, env_steps: int) -> None:
        """From the train loop's ``finally``: save the final state. While
        another exception propagates, a failing save is reported, not
        raised, so the original error survives."""
        if self.checkpointer is None:
            return
        in_flight = sys.exc_info()[0] is not None
        try:
            self.save_now(state, env_steps)
        # lint: broad-except-ok(crash-path boundary: the original propagating exception must survive a failing final save)
        except Exception:
            if not in_flight:
                raise
            traceback.print_exc()
            print("asyncrl_tpu_torch: final checkpoint save failed while handling another "
                  "exception (above); re-raising the original.", file=sys.stderr)

    def close(self) -> None:
        """Writes are synchronous: nothing is pending."""


# Config fields whose change alters the saved state's structure (the JAX
# package's list): resuming across a change to one of them is refused.
_STRUCTURAL_FIELDS = (
    "algo", "optimizer", "lr_schedule", "torso", "hidden_sizes", "channels",
    "core", "core_size", "dueling", "num_envs", "normalize_obs",
    "normalize_returns", "selfplay", "backend", "env_id",
)


def config_snapshot(config) -> dict:
    """The full Config as JSON (tuples become lists)."""
    return dataclasses.asdict(config)


def check_config_compat(saved: dict | None, config) -> None:
    """A checkpoint's config against the resuming one: a structural field
    that differs raises, any other drift is printed."""

    def norm(v):
        return list(v) if isinstance(v, tuple) else v

    if not saved:
        return
    current = config_snapshot(config)
    broken = [f for f in _STRUCTURAL_FIELDS
              if f in saved and norm(saved[f]) != norm(current.get(f))]
    if broken:
        detail = ", ".join(
            f"{f}: checkpoint={saved[f]!r} vs current={current.get(f)!r}" for f in broken
        )
        raise ValueError(
            "checkpoint was written by a run whose config differs in "
            f"state-structure-affecting fields — {detail}. Resume with a "
            "matching config, or start a fresh checkpoint_dir."
        )
    drifted = sorted(f for f in saved
                     if f not in _STRUCTURAL_FIELDS and norm(saved[f]) != norm(current.get(f)))
    if drifted:
        print("asyncrl_tpu_torch: resuming with changed hyperparameters: "
              + ", ".join(f"{f} {saved[f]!r}->{current.get(f)!r}" for f in drifted),
              file=sys.stderr)


def setup(config, restore: str | None, state) -> tuple[TrainerCheckpointing, int]:
    """The trainer's checkpoint wiring; returns ``(hook, env_steps)`` after
    restoring into ``state`` in place where there is something to restore:

    - ``restore=path`` restores from ``path`` read-only (never created or
      written; an empty or missing path raises);
    - ``config.checkpoint_dir`` receives the saves, and when it already
      holds checkpoints (and no ``restore`` is given) training resumes from
      its latest step;
    - neither: a hook that does nothing.
    """
    if config.checkpoint_best and not (config.checkpoint_dir and config.eval_every > 0):
        raise ValueError(
            "checkpoint_best requires BOTH checkpoint_dir (somewhere to "
            "save) and eval_every > 0 (a score to rank by)"
        )
    env_steps = 0
    if restore is not None:
        src = Checkpointer(restore, create=False)
        if src.latest_step() is None:
            raise FileNotFoundError(f"no checkpoint under {restore!r}")
        check_config_compat(src.read_meta().get("config"), config)
        env_steps = src.restore(state)
    if not config.checkpoint_dir:
        return TrainerCheckpointing(None, 0), env_steps

    ckpt = Checkpointer(config.checkpoint_dir)
    ckpt.set_extra_meta(config=config_snapshot(config))
    latest = ckpt.latest_step()
    if restore is None and latest is not None:
        check_config_compat(ckpt.read_meta().get("config"), config)
        env_steps = ckpt.restore(state)
    elif restore is not None and latest is not None and latest > state.update_step:
        raise ValueError(
            f"checkpoint_dir {config.checkpoint_dir!r} already holds steps up to {latest}, "
            f"ahead of the restored step {state.update_step} from {restore!r}; use a fresh "
            "checkpoint_dir or clean the old run's checkpoints"
        )
    best_dir = config.checkpoint_dir.rstrip("/") + "-best" if config.checkpoint_best else None
    return TrainerCheckpointing(ckpt, config.checkpoint_every, best_dir), env_steps
