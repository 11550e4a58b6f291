"""Offline match viewer: renders recorded matches to images / video frames
(the JAX package's tools/viewer.py).

The training-parity slice of the reference's interactive viewer
(src/viz.cpp + src/viewer.cpp, SURVEY.md §2.10 'minimum = replay/event dump
+ offline Python visualizer'): top-down map render with agent positions,
aim directions, HP, shot tracers, zone boxes, and score overlays, driven by
either a record log (StepLog stream) or an event-log steps.bin
(PackedStepSnapshot stream), through the port's data/recorder.py and
assets/formats.py. A host tool: it reads files and draws with matplotlib
(imported only where it renders), with no device work.

Usage:
    # from an event log directory (steps.bin quantized snapshots)
    python -m madrona_mp_env_tpu_torch.tools.viewer \\
        --events <dir> --scene data/simple_map --world 0 --out frames/

    # from a full-precision record log
    python -m madrona_mp_env_tpu_torch.tools.viewer \\
        --record rec.bin --num-worlds 4 --scene data/simple_map --world 0 \\
        --out frames/ --stride 10
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def _load_map_geometry(scene_dir):
    from ..assets import formats

    col = formats.load_collision_data(
        os.path.join(scene_dir, "collisions.bin")
    )
    zones = formats.load_zones(os.path.join(scene_dir, "zones.bin"))
    return col, zones


def _setup_axes(ax, col):
    tri = col.tri_verts  # [T, 3, 3]
    for t in tri:
        xs = np.append(t[:, 0], t[0, 0])
        ys = np.append(t[:, 1], t[0, 1])
        ax.plot(xs, ys, color="#cccccc", linewidth=0.4, zorder=0)
    ax.set_aspect("equal")
    lo = col.world_bounds_min
    hi = col.world_bounds_max
    ax.set_xlim(lo[0] - 20, hi[0] + 20)
    ax.set_ylim(lo[1] - 20, hi[1] + 20)
    ax.set_xticks([])
    ax.set_yticks([])


def render_frame(
    ax,
    col,
    zones,
    pos,  # [12, 3]
    yaw,  # [12]
    hp,  # [12]
    alive,  # [12] bool
    fired,  # [12] bool
    team_size: int,
    cur_zone: int,
    title: str = "",
):
    _setup_axes(ax, col)

    # active zone
    if 0 <= cur_zone < len(zones.aabb_min):
        zmin = zones.aabb_min[cur_zone]
        zmax = zones.aabb_max[cur_zone]
        ax.add_patch(
            __import__("matplotlib.patches", fromlist=["Rectangle"]).Rectangle(
                (zmin[0], zmin[1]),
                zmax[0] - zmin[0],
                zmax[1] - zmin[1],
                fill=True,
                alpha=0.15,
                color="#7b61c9",
                zorder=1,
            )
        )

    colors = ["#2d7ff0", "#e05d44"]
    for i in range(len(pos)):
        if not alive[i]:
            continue
        team = i // team_size if i < 2 * team_size else 0
        c = colors[min(team, 1)]
        ax.scatter(pos[i, 0], pos[i, 1], s=60, color=c, zorder=3)
        dx, dy = 30 * np.cos(yaw[i] + np.pi / 2), 30 * np.sin(yaw[i] + np.pi / 2)
        ax.plot(
            [pos[i, 0], pos[i, 0] + dx],
            [pos[i, 1], pos[i, 1] + dy],
            color=c,
            linewidth=1.2 if not fired[i] else 2.5,
            alpha=0.9 if fired[i] else 0.5,
            zorder=2,
        )
        ax.annotate(
            f"{int(hp[i])}",
            (pos[i, 0], pos[i, 1] + 14),
            fontsize=6,
            ha="center",
            zorder=4,
        )
    ax.set_title(title, fontsize=9)


def frames_from_snapshots(snaps, world: int):
    """PackedStepSnapshot records -> per-frame dicts for one world."""
    worlds = (snaps["match_id"] >> 32).astype(np.int64)
    sel = snaps[worlds == world]
    for s in sel:
        pl = s["players"]
        yield {
            "pos": pl["pos"].astype(np.float32),
            "yaw": pl["yaw"].astype(np.float32) * (np.pi / 32768.0),
            "hp": pl["hp"].astype(np.float32),
            "alive": pl["hp"] > 0,
            "fired": (pl["flags"] & 2) != 0,
            "step": int(s["match_state"]["step"]),
            "cur_zone": int(s["match_state"]["cur_zone"]),
            "controller": int(s["match_state"]["cur_zone_controller"]),
        }


def frames_from_record(path: str, num_worlds: int, world: int):
    from ..data.recorder import ReplayLogReader

    reader = ReplayLogReader(path, num_worlds)
    for i in range(len(reader)):
        log = reader.step(i)
        yield {
            "pos": log["pos"][world],
            "yaw": log["aim_yaw"][world],
            "hp": log["hp"][world],
            "alive": log["hp"][world] > 0,
            "fired": log["fired_shot_t"][world] >= 0,
            "step": int(log["cur_step"][world]),
            "cur_zone": -1,
            "controller": -1,
        }


def render_heatmap(out_path, col, frames, team_size, bins=64):
    """Position-occupancy heatmap over a match (the viewer's heatmap
    overlays, viz.cpp:1070+), one panel per team."""
    import matplotlib.pyplot as plt

    lo = col.world_bounds_min
    hi = col.world_bounds_max
    pts = {0: [], 1: []}
    for fr in frames:
        for i in range(2 * team_size):
            if fr["alive"][i]:
                pts[i // team_size].append(fr["pos"][i, :2])

    fig, axes = plt.subplots(1, 2, figsize=(11, 5), dpi=100)
    for team, ax in enumerate(axes):
        _setup_axes(ax, col)
        if pts[team]:
            p = np.asarray(pts[team])
            ax.hist2d(
                p[:, 0], p[:, 1], bins=bins,
                range=[[lo[0], hi[0]], [lo[1], hi[1]]],
                cmap="magma", alpha=0.85, zorder=2, cmin=1,
            )
        ax.set_title(f"team {team} occupancy", fontsize=9)
    fig.savefig(out_path)
    plt.close(fig)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--events", type=str, help="event log dir (steps.bin)")
    ap.add_argument("--record", type=str, help="record log path")
    ap.add_argument("--num-worlds", type=int, default=1)
    ap.add_argument("--scene", type=str, required=True)
    ap.add_argument("--world", type=int, default=0)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--stride", type=int, default=1)
    ap.add_argument("--team-size", type=int, default=6)
    ap.add_argument("--max-frames", type=int, default=200)
    ap.add_argument("--heatmap", action="store_true",
                    help="render a per-team occupancy heatmap instead of "
                         "per-step frames")
    args = ap.parse_args(argv)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    col, zones = _load_map_geometry(args.scene)

    if args.events:
        from ..data.recorder import read_step_snapshots

        frames = frames_from_snapshots(
            read_step_snapshots(args.events), args.world
        )
    elif args.record:
        frames = frames_from_record(args.record, args.num_worlds, args.world)
    else:
        print("need --events or --record", file=sys.stderr)
        sys.exit(1)

    os.makedirs(args.out, exist_ok=True)

    if args.heatmap:
        out_path = os.path.join(args.out, "heatmap.png")
        render_heatmap(out_path, col, frames, args.team_size)
        print(f"wrote {out_path}")
        return

    n = 0
    for i, fr in enumerate(frames):
        if i % args.stride != 0:
            continue
        if n >= args.max_frames:
            break
        fig, ax = plt.subplots(figsize=(6, 5), dpi=100)
        title = f"step {fr['step']}"
        if fr["cur_zone"] >= 0:
            title += f"  zone {fr['cur_zone']}"
            if fr["controller"] >= 0:
                title += f"  held by team {fr['controller']}"
        render_frame(
            ax, col, zones, fr["pos"], fr["yaw"], fr["hp"], fr["alive"],
            fr["fired"], args.team_size, fr["cur_zone"], title,
        )
        fig.savefig(os.path.join(args.out, f"frame_{n:05d}.png"))
        plt.close(fig)
        n += 1
    print(f"wrote {n} frames to {args.out}")


if __name__ == "__main__":
    main()
