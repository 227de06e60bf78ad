"""Interactive-server load test: N rooms x M actions over real TCP.

Measures what PERF.md previously asserted qualitatively ("microseconds
on the host" for the native backend): per-action latency from the head
player's ``play`` line hitting the socket to that player receiving the
resulting board broadcast (``board-action`` -> ``update-players``, the
reference hot path ``server.clj:107-130`` / ``board.clj:122-129``), and
aggregate actions/s with all rooms playing concurrently.

    python scripts/bench_server.py [--rooms 16] [--players 3]
        [--actions 200] [--backend native] [--save data/server_load.json]

Every action is a call (amt 0) so hands run forever (reference rules:
perpetual redeal, busted players never eliminated — gameplay.clj:149).
The jax backend steps each action through the XLA engine on the rooms'
device (``server.backends.room_device``).
"""

import argparse
import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


async def run_room(port: int, room: str, n_players: int, n_actions: int,
                   latencies: list):
    """One room: connect players, create+join, then drive n_actions calls
    from whichever player heads the play order, timing send->broadcast."""
    clients = []
    for _ in range(n_players):
        r, w = await asyncio.open_connection("127.0.0.1", port)
        clients.append({"r": r, "w": w, "pid": None, "boards": []})

    async def send(c, obj):
        c["w"].write((json.dumps(obj) + "\r\n").encode())
        await c["w"].drain()

    async def recv(c, timeout=120.0):
        line = await asyncio.wait_for(c["r"].readline(), timeout)
        return json.loads(line.decode().rstrip())

    for c in clients:
        await send(c, {"type": "whoami"})
        c["pid"] = await recv(c)
    await send(clients[0], {"type": "new_room", "name": room,
                            "n": n_players})
    ack = await recv(clients[0])
    assert ack.get("status") == 0, ack
    for c in clients:
        await send(c, {"type": "join_room", "name": room})

    by_pid = {c["pid"]: c for c in clients}

    # Boards are broadcast ONLY to in-hand seats (host.py _broadcast),
    # and an exact-equality all-in drops a player from in_hand for the
    # rest of the hand (reference quirk, step.py) — so no fixed client
    # is guaranteed a copy of any given board. One reader task per
    # client feeds a shared queue; the drive loop waits for the FIRST
    # copy of a strictly NEWER board (the public "time" logical clock
    # advances with every play), which also keeps every socket buffer
    # drained without blocking on clients the broadcast skipped.
    q: asyncio.Queue = asyncio.Queue()

    async def reader(c):
        while True:
            msg = await c["r"].readline()
            if not msg:
                return
            msg = json.loads(msg.decode().rstrip())
            if isinstance(msg, dict) and "play-order" in msg:
                q.put_nowait((time.perf_counter(), msg))

    readers = [asyncio.ensure_future(reader(c)) for c in clients]

    async def next_board(prev):
        # Later copies of broadcast N can interleave with the first copy
        # of N+1 across sockets, and the logical clock resets per hand —
        # so a "new" board is one whose CONTENT differs from the last
        # seen (stacks/pot/play-order change with every action; copies
        # of one broadcast are byte-identical).
        while True:
            t1, b = await asyncio.wait_for(q.get(), 120.0)
            if b != prev:
                return t1, b

    # game start: hole cards + the first board reach every player
    _, board = await next_board(None)
    head = by_pid[board["play-order"][0]]

    for _ in range(n_actions):
        t0 = time.perf_counter()
        await send(head, {"type": "play", "name": room, "amt": 0})
        t1, board = await next_board(board)
        latencies.append(t1 - t0)
        head = by_pid[board["play-order"][0]]

    for task in readers:
        task.cancel()
    for c in clients:
        c["w"].close()


async def bench(backend: str, rooms: int, players: int, actions: int):
    from montecarlo_tpu.server.host import Registry
    from montecarlo_tpu.server.tcp import start_server

    registry = Registry(backend=backend)
    server, _ = await start_server(registry=registry, host="127.0.0.1",
                                   port=0)
    port = server.sockets[0].getsockname()[1]

    latencies: list = []
    t0 = time.perf_counter()
    await asyncio.gather(*[
        run_room(port, f"load{i}", players, actions, latencies)
        for i in range(rooms)])
    wall = time.perf_counter() - t0
    server.close()
    await server.wait_closed()

    lat = sorted(latencies)

    def pct(p):
        return lat[min(len(lat) - 1, int(p / 100 * len(lat)))]

    return {
        "backend": backend, "rooms": rooms, "players": players,
        "actions_per_room": actions, "total_actions": len(lat),
        "wall_seconds": round(wall, 3),
        "actions_per_sec": round(len(lat) / wall, 1),
        "latency_p50_us": round(pct(50) * 1e6, 1),
        "latency_p90_us": round(pct(90) * 1e6, 1),
        "latency_p99_us": round(pct(99) * 1e6, 1),
        "latency_mean_us": round(sum(lat) / len(lat) * 1e6, 1),
    }


def bench_direct(backend: str, actions: int = 2000):
    """Host-engine action latency without sockets: one room, actions
    dispatched synchronously through Registry.dispatch — the engine+host
    cost per action (the TCP numbers above add event-loop scheduling,
    shared here by every simulated client)."""
    from montecarlo_tpu.server.host import Registry

    registry = Registry(backend=backend)
    inboxes = {}
    pids = []
    seq = iter(range(1 << 62))  # global arrival order across inboxes
    for k in range(3):
        box = []
        pid = registry.add_player(
            lambda msg, box=box: box.append((next(seq), msg)))
        inboxes[pid] = box
        pids.append(pid)
    registry.dispatch(pids[0], {"type": "new_room", "name": "d", "n": 3})
    for pid in pids:
        registry.dispatch(pid, {"type": "join_room", "name": "d"})

    def head_pid():
        # the GLOBALLY newest board: broadcasts skip non-in-hand seats
        # (all-in quirk), so any fixed player's inbox can be stale
        newest, newest_seq = None, -1
        for pid in pids:
            for s, msg in reversed(inboxes[pid]):
                if isinstance(msg, dict) and "play-order" in msg:
                    if s > newest_seq:
                        newest, newest_seq = msg, s
                    break
        if newest is None:
            raise AssertionError("no board broadcast seen")
        return newest["play-order"][0]

    lat = []
    for _ in range(actions):
        pid = head_pid()
        t0 = time.perf_counter()
        registry.dispatch(pid, {"type": "play", "name": "d", "amt": 0})
        lat.append(time.perf_counter() - t0)
    lat.sort()
    return {
        "engine_action_p50_us": round(lat[len(lat) // 2] * 1e6, 1),
        "engine_action_p99_us": round(lat[int(0.99 * len(lat))] * 1e6, 1),
        "engine_actions_per_sec": round(len(lat) / sum(lat), 1),
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--rooms", type=int, default=16)
    ap.add_argument("--players", type=int, default=3)
    ap.add_argument("--actions", type=int, default=200)
    ap.add_argument("--backend", default="native",
                    help="native | jax | auto (jax dispatches per-action "
                         "device programs - keep the chip idle)")
    ap.add_argument("--save", default="data/server_load.json")
    args = ap.parse_args()

    if args.backend != "native":
        # The first jax-backend action jit-compiles the engine dispatch:
        # warm the process (and the persistent compile cache) with a few
        # un-timed direct dispatches before the timed TCP run; room
        # shapes are identical, so nothing recompiles under load.
        from montecarlo_tpu.utils.compile_cache import enable_compile_cache

        enable_compile_cache()
        t0 = time.perf_counter()
        bench_direct(args.backend, actions=4)
        print(json.dumps({"warmup_seconds":
                          round(time.perf_counter() - t0, 1)}),
              flush=True)

    out = asyncio.run(bench(args.backend, args.rooms, args.players,
                            args.actions))
    out.update(bench_direct(args.backend))
    print(json.dumps(out), flush=True)
    if args.save:
        prev = {}
        if os.path.exists(args.save):
            with open(args.save) as f:
                prev = json.load(f)
        prev[args.backend] = out
        with open(args.save, "w") as f:
            json.dump(prev, f, indent=1)
        print(f"saved {args.save}")


if __name__ == "__main__":
    main()
