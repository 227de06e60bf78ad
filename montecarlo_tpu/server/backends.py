"""Interactive-table backends for the server host.

Two engines drive an interactive room, sharing conformance-tested
semantics:

- ``NativeBackend`` (default when the toolchain is available): the C++
  single-table runtime (``native/mcpoker.cpp``) — per-action latency in
  microseconds, the host equivalent of the reference's per-table actor.
- ``JaxBackend``: the device engine stepped one action at a time — always
  available; also the reference implementation the native path is tested
  against.

Both expose the same surface to ``Room``: seat order is *hand order for the
current hand* handled by the backend (button rotation included), and the
public board JSON matches ``read-board`` (``helpers.clj:33-43``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from montecarlo_tpu.engine.public import card_json


def _layers_json(layers, ids_by_pos: Sequence[str]) -> List[Dict]:
    """[(amt, members, orig, n)] in hand-order index space -> JSON."""
    return [{
        "bet": amt,
        "players": [ids_by_pos[j] for j in range(len(ids_by_pos)) if j in mem],
        "original-players": [ids_by_pos[j] for j in range(len(ids_by_pos))
                             if j in orig],
        "n": n,
    } for amt, mem, orig, n in layers]


class NativeBackend:
    """C++ table runtime + host-side dealing and button rotation."""

    def __init__(self, n: int, small: int, big: int, seed: int,
                 stacks: Sequence[int]):
        from montecarlo_tpu import native

        self._native = native
        self.n = n
        self.small, self.big = small, big
        self.rng = np.random.Generator(np.random.PCG64(seed))
        self.button = 0
        self.hand_idx = 0
        self._seat_stacks = list(stacks)  # by seat
        self._deal()

    # hand-order position j <-> seat (button + j) % n
    def _seat(self, pos: int) -> int:
        return (self.button + pos) % self.n

    def _pos(self, seat: int) -> int:
        return (seat - self.button) % self.n

    def _deal(self):
        self.deck = self.rng.permutation(52).astype(np.int32)
        order_stacks = [self._seat_stacks[self._seat(j)] for j in range(self.n)]
        self.table = self._native.NativeTable(
            self.n, self.small, self.big, self.deck, stacks=order_stacks)
        self._pull_stacks()

    def _pull_stacks(self):
        snap = self.table.snapshot()
        for j, v in enumerate(snap["stacks"]):
            self._seat_stacks[self._seat(j)] = v

    # -- Room surface ---------------------------------------------------------
    def info(self) -> Dict:
        snap = self.table.snapshot()
        return {"time": snap["time"], "stage": snap["stage"],
                "hand_idx": self.hand_idx}

    def stacks(self) -> List[int]:
        return list(self._seat_stacks)

    def set_stacks(self, stacks: Sequence[int]):
        """Push new global stacks into the live table (database.clj:8-12:
        stacks are global per-player refs, so a cross-room change is visible
        to this room's in-progress hand immediately — same semantics as
        JaxBackend.set_stacks)."""
        self._seat_stacks = list(stacks)
        order_stacks = [self._seat_stacks[self._seat(j)]
                        for j in range(self.n)]
        self.table.set_stacks(order_stacks)

    def in_hand_seats(self) -> List[int]:
        snap = self.table.snapshot()
        return sorted(self._seat(j) for j in snap["in_hand"])

    def hole(self, seat: int):
        j = self._pos(seat)
        return int(self.deck[j]), int(self.deck[self.n + j])

    def head_seat(self) -> Optional[int]:
        snap = self.table.snapshot()
        return None if snap["head"] is None else self._seat(snap["head"])

    def act(self, amt: int) -> bool:
        """Apply one action; returns True if the hand ended (new hand dealt)."""
        self.table.act(int(amt))
        snap = self.table.snapshot()
        if snap["over"]:
            self.table.settle()
            self._pull_stacks()
            self.button = (self.button + 1) % self.n
            self.hand_idx += 1
            self._deal()
            return True
        self._pull_stacks()
        return False

    def board_json(self, ids: Sequence[str]) -> Dict:
        snap = self.table.snapshot()
        ids_by_pos = [ids[self._seat(j)] for j in range(self.n)]
        n_players = len(snap["in_hand"])
        order, cursor = snap["order"], snap["cursor"]
        play_order = []
        k = cursor
        while len(play_order) < n_players and order:
            play_order.append(ids_by_pos[order[k % len(order)]])
            k += 1
        return {
            "community-cards": [
                card_json(int(c)) for c in
                [self.deck[2 * self.n + 1], self.deck[2 * self.n + 2],
                 self.deck[2 * self.n + 3], self.deck[2 * self.n + 5],
                 self.deck[2 * self.n + 7]][: snap["n_revealed"]]],
            "bets": _layers_json(snap["bets"], ids_by_pos),
            "pots": _layers_json(snap["pots"], ids_by_pos),
            "remaining-players": [ids_by_pos[j] for j in range(self.n)
                                  if j in snap["remaining"]],
            "play-order": play_order,
            "time": snap["time"],
            "players": [{"id": ids_by_pos[j],
                         "stack": snap["stacks"][j]}
                        for j in range(self.n) if j in snap["in_hand"]],
        }


# Platform of the device that holds every interactive room's state
# ("cpu" or the accelerator's, e.g. "gpu"). See ``JaxBackend``.
ROOM_PLATFORM = "cpu"


def room_device():
    """The device interactive rooms run on (``ROOM_PLATFORM``)."""
    import jax

    return jax.devices(ROOM_PLATFORM)[0]


class JaxBackend:
    """Device engine stepped from the host (always available; the only
    backend supporting the "standard" and "tournament" rule sets).

    An interactive room is ONE table stepped once per wire action: each
    action is a single jitted ``step_table`` call plus a few host reads
    of the state, mirroring the hot path ``server.clj:119`` →
    ``board.clj:122`` one compiled step deep. There is nothing for an
    accelerator to amortize in one table, while every step placed on it
    pays a kernel launch and a device-to-host copy per read; so the room
    lives on ``room_device()``, the host CPU by default, even when the
    process also holds a GPU for batch work: a room of five house bots
    answered a client's action in 22 ms p50 with its state on the host
    CPU and in 76 ms on an NVIDIA H100 (``chip_smoke.py`` measures
    both)."""

    def __init__(self, n: int, small: int, big: int, seed: int,
                 stacks: Sequence[int], rules: str = "reference"):
        import jax
        import jax.numpy as jnp

        from montecarlo_tpu.engine.state import TableConfig, init_state
        from montecarlo_tpu.engine.step import (
            clamp_action, head_info, step_table,
        )

        self.n = n
        self.rules = rules
        self._dev = room_device()
        cfg = TableConfig(num_seats=n, small_blind=small, big_blind=big,
                          rules=rules)
        with jax.default_device(self._dev):
            state = init_state(jax.random.key(seed), cfg)
            posted = np.asarray(state.stacks) - cfg.starting_stack
            state = state._replace(
                stacks=jnp.asarray(np.asarray(stacks, np.int32) + posted))
        self.state = jax.device_put(state, self._dev)
        self._step = jax.jit(
            lambda s, a: step_table(s, clamp_action(s, a), rules=rules))
        # jitted, head_info runs where the committed state lives (eagerly,
        # its uncommitted iota would run on the default device)
        self._head = jax.jit(head_info)

    # Device state is positional; seats are stable. seat = (button+pos)%n.
    def _pos(self, seat: int) -> int:
        return (seat - int(self.state.button)) % self.n

    def _seat(self, pos: int) -> int:
        return (int(self.state.button) + pos) % self.n

    def info(self) -> Dict:
        return {"time": int(self.state.time), "stage": int(self.state.stage),
                "hand_idx": int(self.state.hand_idx)}

    def stacks(self) -> List[int]:
        pos_stacks = np.asarray(self.state.stacks)
        return [int(pos_stacks[self._pos(s)]) for s in range(self.n)]

    def set_stacks(self, stacks: Sequence[int]):
        import jax

        positional = [stacks[self._seat(j)] for j in range(self.n)]
        self.state = self.state._replace(
            stacks=jax.device_put(np.asarray(positional, np.int32),
                                  self._dev))

    def in_hand_seats(self) -> List[int]:
        pos = np.nonzero(np.asarray(self.state.in_hand))[0].tolist()
        return sorted(self._seat(j) for j in pos)

    def hole(self, seat: int):
        h = np.asarray(self.state.hole)
        j = self._pos(seat)
        return int(h[j, 0]), int(h[j, 1])

    def head_seat(self) -> Optional[int]:
        pos, _, exists = self._head(self.state)
        return self._seat(int(pos)) if bool(exists) else None

    def act(self, amt: int) -> bool:
        """Apply one action; True iff the hand ended AND a fresh hand was
        dealt (a tournament table that froze returns False — no new deal).

        One jitted ``step_table`` call (clamp → apply → street
        transition(s) → settle+redeal on game end, ``board.clj:122-129``
        + ``gameplay.clj:122-150``) and one host read — no per-op eager
        dispatch on the hot path."""
        import jax

        if self.rules == "tournament" and bool(self.state.hand_over):
            return False  # frozen table: one player holds all the chips
        prev_idx = int(self.state.hand_idx)
        self.state = self._step(
            self.state, jax.device_put(np.int32(amt), self._dev))
        return int(self.state.hand_idx) > prev_idx

    def board_json(self, ids: Sequence[str]) -> Dict:
        from montecarlo_tpu.engine.public import public_board

        return public_board(self.state, ids)

    # -- house bots (server extension; the reference's purpose is "test
    # AIs", README.md:9 — bot seats close that loop over the wire) ------
    def make_bot(self, params):
        """Jitted ``(key, state) -> engine action`` from an MLP policy
        (models/policy_net.py:net_policy — categorical over the masked
        fold/call/2bb/pot menu)."""
        import jax

        from montecarlo_tpu.models.policy_net import net_policy

        pol = net_policy(jax.device_put(params, self._dev))
        return jax.jit(lambda key, state: pol(key, state, 0))

    def bot_action(self, fn, key) -> int:
        import jax

        # The host makes keys on the default device; co-locate with the
        # table so the jitted policy runs where the room lives.
        return int(fn(jax.device_put(key, self._dev), self.state))


def make_backend(kind: str, n: int, small: int, big: int, seed: int,
                 stacks: Sequence[int], rules: str = "reference"):
    if rules != "reference":
        # The C++ table implements the reference semantics only; standard
        # and tournament rooms run on the device engine.
        return JaxBackend(n, small, big, seed, stacks, rules=rules)
    if kind == "native":
        return NativeBackend(n, small, big, seed, stacks)
    if kind == "jax":
        return JaxBackend(n, small, big, seed, stacks)
    if kind == "auto":
        from montecarlo_tpu import native

        if native.available():
            return NativeBackend(n, small, big, seed, stacks)
        return JaxBackend(n, small, big, seed, stacks)
    raise ValueError(f"unknown backend {kind!r}")
