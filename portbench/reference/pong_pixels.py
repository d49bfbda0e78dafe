"""Plain pixel Pong: the game of ``JaxPongPixels-v0`` as the configurations
run it (the scripted ``tracker`` rival, one game step an env step, no
sticky actions, no frame pooling), painted to ``[B, 84, 84, 4]`` uint8
stacks of the last four frames.

A frozen, standalone copy of the game's arithmetic, written out operation
for operation so that on one device it gives the same bits as the system
under test. It imports nothing of the system. The random values a run
consumes come from the caller's generator in a fixed order: ``init`` draws
``rand(B)`` for the side, then ``rand(B)`` for the serve; each ``draw``
draws ``rand(B)`` for the re-serve, ``rand(B)`` for the side of a reset and
``rand(B)`` for its serve.
"""

from __future__ import annotations

import numpy as np
import torch

AGENT_X = 0.95
OPP_X = 0.05
PADDLE_HALF = 0.08
AGENT_SPEED = 0.05
OPP_SPEED = 0.025
BALL_VX = 0.03
MAX_SPIN = 0.04
SERVE_VY = 0.02
WIN_SCORE = 21
FRAME = 84
NUM_ACTIONS = 6

# MAX_SPIN / PADDLE_HALF as one f32 constant times the offset.
_SPIN_GAIN = float(np.float32(MAX_SPIN) * np.float32(np.float32(1.0) / np.float32(PADDLE_HALF)))


def check_settings(program: dict) -> None:
    """Raise unless the configuration asks for the game this file plays."""
    wanted = {"env_id": "JaxPongPixels-v0", "pong_opponent": "tracker",
              "pong_opponent_speed": 0.0, "frame_skip": 1, "frame_pool": False,
              "sticky_actions": 0.0}
    for key, value in wanted.items():
        if program.get(key) != value:
            raise ValueError(f"the plain pixel Pong plays {key}={value!r}, "
                             f"the configuration asks {program.get(key)!r}")


def make(program: dict) -> "PongPixels":
    """The game the configuration's ``program`` settings ask for."""
    check_settings(program)
    return PongPixels(max_steps=program["pong_max_steps"])


def _uniform_vy(batch, generator, device):
    u = torch.rand(batch, generator=generator, device=device)
    return u * (2 * SERVE_VY) - SERVE_VY


def _serve(toward_agent, vy):
    half = torch.full_like(vy, 0.5)
    vx = torch.where(toward_agent, BALL_VX, -BALL_VX).to(vy.dtype)
    return torch.stack([half, half, vx, vy], dim=-1)


def _fresh(toward_agent, vy):
    batch = vy.shape[0]
    return {
        "ball": _serve(toward_agent, vy),
        "agent_y": torch.full_like(vy, 0.5),
        "opp_y": torch.full_like(vy, 0.5),
        "score": torch.zeros(batch, 2, dtype=torch.int32, device=vy.device),
        "t": torch.zeros(batch, dtype=torch.int32, device=vy.device),
    }


class PongPixels:
    """``B`` games stepped together; the state is a dict of ``[B, ...]``
    tensors plus the frame stack."""

    num_actions = NUM_ACTIONS

    def __init__(self, max_steps: int):
        self.max_steps = max_steps
        self._coords = {}

    def coords(self, device):
        """Pixel centres i / 83, divided on the CPU and moved."""
        device = torch.device(device)
        if device not in self._coords:
            self._coords[device] = (torch.arange(FRAME, dtype=torch.float32) / (FRAME - 1)
                                    ).to(device)
        return self._coords[device]

    def render(self, game) -> torch.Tensor:
        coords = self.coords(game["ball"].device)
        ball_x, ball_y = game["ball"][:, 0], game["ball"][:, 1]
        half_w = 1.5 / FRAME

        def rows_near(center, half):
            return ((coords - center[:, None]).abs() <= half)[:, :, None]

        def cols_near(center):
            return ((coords - center).abs() <= half_w)[None, None, :]

        img = (
            (cols_near(AGENT_X) & rows_near(game["agent_y"], PADDLE_HALF))
            | (cols_near(OPP_X) & rows_near(game["opp_y"], PADDLE_HALF))
            | (((coords - ball_x[:, None]).abs() <= half_w)[:, None, :]
               & rows_near(ball_y, half_w))
        )
        return img.to(torch.uint8)

    def init(self, batch, generator, device):
        toward = torch.rand(batch, generator=generator, device=device) < 0.5
        game = _fresh(toward, _uniform_vy(batch, generator, device))
        frame = self.render(game)
        return {"game": game, "frames": frame[..., None].expand(*frame.shape, 4).contiguous()}

    def draw(self, batch, generator, device):
        serve_vy = _uniform_vy(batch, generator, device)
        toward = torch.rand(batch, generator=generator, device=device) < 0.5
        return serve_vy, toward, _uniform_vy(batch, generator, device)

    def step(self, state, action, draws):
        """``(state, reward, terminated, truncated)`` after ``action [B]``;
        the new observation is ``state["frames"]``."""
        serve_vy, reset_toward, reset_vy = draws
        g = state["game"]
        up = ((action == 2) | (action == 4)).float()
        down = ((action == 3) | (action == 5)).float()
        agent_y = torch.clamp(g["agent_y"] + AGENT_SPEED * (up - down),
                              PADDLE_HALF, 1.0 - PADDLE_HALF)
        opp_delta = torch.clamp(g["ball"][:, 1] - g["opp_y"], -OPP_SPEED, OPP_SPEED)
        opp_y = torch.clamp(g["opp_y"] + opp_delta, PADDLE_HALF, 1.0 - PADDLE_HALF)

        bx, by, vx, vy = g["ball"].unbind(-1)
        x = bx + vx
        y = by + vy
        y = torch.where(y < 0.0, -y, y)
        vy = torch.where(by + vy < 0.0, vy.abs(), vy)
        over = y > 1.0
        vy = torch.where(over, -vy.abs(), vy)
        y = torch.where(over, 2.0 - y, y)

        cross_agent = (x >= AGENT_X) & (vx > 0)
        cross_opp = (x <= OPP_X) & (vx < 0)
        agent_hit = cross_agent & ((y - agent_y).abs() <= PADDLE_HALF)
        opp_hit = cross_opp & ((y - opp_y).abs() <= PADDLE_HALF)
        new_x = torch.where(agent_hit, 2.0 * AGENT_X - x, torch.where(opp_hit, 2.0 * OPP_X - x, x))
        new_vx = torch.where(agent_hit, -1.0 * BALL_VX, torch.where(opp_hit, 1.0 * BALL_VX, vx))
        new_vy = torch.where(agent_hit, (y - agent_y) * _SPIN_GAIN,
                             torch.where(opp_hit, (y - opp_y) * _SPIN_GAIN, vy))

        opp_scores = cross_agent & ~agent_hit
        agent_scores = cross_opp & ~opp_hit
        reward = agent_scores.float() - opp_scores.float()
        score = g["score"] + torch.stack([agent_scores, opp_scores], dim=-1).int()
        point = agent_scores | opp_scores
        ball = torch.stack([new_x, y, new_vx, new_vy], dim=-1)
        ball = torch.where(point[:, None], _serve(opp_scores, serve_vy), ball)

        t = g["t"] + 1
        terminated = (score[:, 0] >= WIN_SCORE) | (score[:, 1] >= WIN_SCORE)
        truncated = (t >= self.max_steps) & ~terminated
        done = terminated | truncated

        ended = {"ball": ball, "agent_y": agent_y, "opp_y": opp_y, "score": score, "t": t}
        fresh = _fresh(reset_toward, reset_vy)
        game = {k: torch.where(done.view(-1, *([1] * (v.dim() - 1))), fresh[k], v)
                for k, v in ended.items()}
        frame = self.render(game)
        shifted = torch.cat([state["frames"][..., 1:], frame[..., None]], dim=-1)
        restart = frame[..., None].expand(*frame.shape, 4).contiguous()
        frames = torch.where(done[:, None, None, None], restart, shifted)
        return {"game": game, "frames": frames}, reward, terminated, truncated
