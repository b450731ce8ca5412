#!/usr/bin/env python3
"""Where the loop-closing lap parts from the reference: frame by frame, on the CPU.

    JAX_PLATFORMS=cpu python tools/loop_trace.py --side ref  --out DIR
    JAX_PLATFORMS=cpu python tools/loop_trace.py --side port --out DIR [--lbd-oracle]
    JAX_PLATFORMS=cpu python tools/loop_trace.py --compare DIR/ref.npz DIR/port.npz
    JAX_PLATFORMS=cpu python tools/loop_trace.py --lockstep N [--frontend-oracle] [--probe F]

The scenario is the reference's loop test (tests/test_loop_scenarios.py:65-100,
chip_smoke.py phase 2d): `make_cylinder_scene(700, 48, seed=0)`, a 200-frame
1.3-lap circle, noise 2.0, `SLAMConfig(camera=CameraConfig(fy=480.0),
enable_loop_closing=True)`, rendered once by the JAX package's
`io/synthetic.py` and fed to both packages as the same numpy frames. Each
side bootstraps through `track()` (within 12 frames) and streams the rest
through one `track_sequence()` call; the reference runs its per-frame path
(`SCAN_CHUNK` above the sequence length), which is the path the port has.

Free runs. `--side` records, per frame, the keyframe decision, `ok`, the
inlier count, the tracked pose and the cursors `n_kf` / `n_mp` / `n_ml`, and
per loop-closer `detect` call the keyframe and its candidate list, into
`ref.npz`, `port.npz` or `port_oracle.npz` under `--out` (~5 min a side
on an 8-core CPU). `--compare` prints the first frame at which the two differ beyond the
slice tests' bounds: any decision, cursor or candidate list, or a pose
beyond 2e-3 (tests/test_torch_line_mapping.py's bound). `--lbd-oracle` gives
the port the reference's `ops/lbd.py describe_lines`, jitted alone, on the
port's own image and segments.

Lockstep. `--lockstep N` runs the reference alone up to frame N and, before
each of its per-frame steps, hands its carry (convert.py) and the frame to
the port's `pipeline.slam_step`, so a difference is that one step's own, not
drift carried in. Per frame it prints how the two frontends differ and both
steps' decisions, cursors and poses; `--frontend-oracle` gives the port's
step the reference's frame (ORB, LSD, LBD, each jitted alone). `--probe F`
looks inside frame F's keyframe step: the reference's own functions, each
jitted alone, on the port's `insert_keyframe` inputs; the keyframe's fields
as the reference's whole jitted step stored them against the port's; the
lines one made and the other did not, with each neighbour's match, its MAD
margin gate and the float64 gates of `create_new_lines`; and the port's step
again with the line descriptors of the reference's whole step.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

N_FRAMES, LAPS, INIT_MAX = 200, 1.3, 12
POSE_TOL = 2e-3


def scenario():
    from structure_slam_pointline_tpu.config import CameraConfig
    from structure_slam_pointline_tpu.io import synthetic

    cam = CameraConfig(fy=480.0)
    scene = synthetic.make_cylinder_scene(n_points=700, n_lines=48, seed=0)
    poses = synthetic.loop_trajectory(N_FRAMES, laps=LAPS)
    return synthetic.render_sequence(scene, poses, cam, noise=2.0), poses


def _numpy(nt) -> dict:
    """A JAX NamedTuple (nested ones too) -> dict of numpy arrays."""
    import jax

    d = jax.device_get(nt)._asdict()
    return {k: (_numpy(v) if hasattr(v, "_asdict") else np.asarray(v)) for k, v in d.items()}


# ---------------------------------------------------------------- free runs

class Trace:
    """Per-frame rows and per-detect candidate lists of one run."""

    def __init__(self):
        self.rows, self.cands = [], []

    def frame(self, fid, ok, is_kf, n_inl, T, n_kf, n_mp, n_ml):
        T = np.zeros((4, 4), np.float32) if T is None else np.asarray(T, np.float32)
        self.rows.append((fid, ok, is_kf, n_inl, n_kf, n_mp, n_ml, T))

    def record_detect(self, lc):
        detect = lc.detect

        def recorded(state, n_kf, k):
            out = detect(state, n_kf, k)
            self.cands.append((int(k), [int(c.kf_id) for c in out]))
            return out
        lc.detect = recorded

    def save(self, path, extra):
        cols = list(zip(*self.rows))
        cands = np.full((len(self.cands), 9), -1, np.int32)
        for i, (k, ids) in enumerate(self.cands):
            cands[i, 0] = k
            cands[i, 1:1 + min(len(ids), 8)] = ids[:8]
        np.savez(path, **{name: np.array(c) for name, c in zip(
            ("fid", "ok", "is_kf", "n_inl", "n_kf", "n_mp", "n_ml"), cols)},
                 T=np.stack(cols[7]), cands=cands, **extra)


def _stream(slam, imgs) -> dict:
    """Bootstrap through `track()`, then one `track_sequence()` call."""
    t0 = time.time()
    i = 0
    while slam.carry is None and i < INIT_MAX:
        slam.track(imgs[i], i)
        i += 1
    if slam.carry is None:
        raise SystemExit(f"no bootstrap within {INIT_MAX} frames")
    slam.track_sequence(imgs[i:], i)
    traj = slam.trajectory()
    ids = sorted(traj)
    return {"init_frame": i - 1, "seconds": time.time() - t0,
            "counters": str(dict(slam.metrics.counters)), "traj_ids": np.array(ids),
            "traj_T": np.stack([traj[k] for k in ids])}


def _ref_system():
    from structure_slam_pointline_tpu.config import CameraConfig, SLAMConfig
    from structure_slam_pointline_tpu.models.system import SLAMSystem

    slam = SLAMSystem(SLAMConfig(camera=CameraConfig(fy=480.0), enable_loop_closing=True))
    slam.SCAN_CHUNK = 10 ** 6                      # every frame on the per-frame path
    return slam


def run_ref(imgs):
    slam = _ref_system()
    trace = Trace()
    trace.record_detect(slam._get_loop_closer())
    step = slam._step_with_recovery

    def recorded(img_np, img_j, fid):
        T, ok, n_inl, is_kf = out = step(img_np, img_j, fid)
        slam.sync_cursors()
        c = slam.cur
        trace.frame(fid, ok, is_kf, n_inl, T, c.n_kf, c.n_mp, c.n_ml)
        return out
    slam._step_with_recovery = recorded
    return trace, _stream(slam, imgs)


def run_port(imgs, lbd_oracle: bool):
    import torch

    from structure_slam_pointline_tpu_torch.config import CameraConfig, SLAMConfig
    from structure_slam_pointline_tpu_torch.models.system import SLAMSystem

    torch.set_num_threads(1)
    if lbd_oracle:
        _use_reference_lbd()
    slam = SLAMSystem(SLAMConfig(camera=CameraConfig(fy=480.0), enable_loop_closing=True),
                      device="cpu")
    trace = Trace()
    trace.record_detect(slam._get_loop_closer())
    step, track_sequence, outs = slam._step, slam.track_sequence, {}

    def recorded_step(img, fid):
        outs[fid] = step(img, fid)
        return outs[fid]

    # `track_sequence` reacts to a lost frame after `_step`: each frame is
    # recorded from the call's own outputs, its cursors from `_step`'s
    def recorded_sequence(seq, first):
        T, ok, inl, kf = out = track_sequence(seq, first)
        for j in range(len(seq)):
            o = outs[first + j]
            trace.frame(first + j, bool(ok[j]), bool(kf[j]), int(inl[j]), T[j],
                        o.n_kf, o.n_mp, o.n_ml)
        return out
    slam._step, slam.track_sequence = recorded_step, recorded_sequence
    return trace, _stream(slam, imgs)


def _use_reference_lbd():
    """The port's LBD replaced by the reference's on the same inputs."""
    import jax.numpy as jnp
    import torch

    from structure_slam_pointline_tpu.ops import lbd as jlbd
    from structure_slam_pointline_tpu_torch.ops import lbd as tlbd

    def reference(img, endpoints, valid):
        packed, desc = jlbd.describe_lines(jnp.asarray(img.numpy()),
                                           jnp.asarray(endpoints.numpy()),
                                           jnp.asarray(valid.numpy()))
        return (torch.from_numpy(np.asarray(packed).view(np.int32).copy()),
                torch.from_numpy(np.asarray(desc).copy()))
    tlbd.describe_lines = reference


def compare(ref_path, port_path):
    from structure_slam_pointline_tpu.io import synthetic

    a, b = np.load(ref_path), np.load(port_path)
    poses = synthetic.loop_trajectory(N_FRAMES, laps=LAPS)
    print(f"init frame: ref {int(a['init_frame'])}, port {int(b['init_frame'])}")
    for name, d in (("ref", a), ("port", b)):
        est = np.stack([np.linalg.inv(T) for T in d["traj_T"]])
        print(f"{name}: {len(d['fid'])} frames, {int(d['ok'].sum())} ok, n_kf {int(d['n_kf'][-1])},"
              f" n_mp {int(d['n_mp'][-1])}, n_ml {int(d['n_ml'][-1])}, ATE-Sim3"
              f" {synthetic.ate_rmse(est, poses[d['traj_ids']]):.5f}, {float(d['seconds']):.0f} s,"
              f" {d['counters']}")
    first = None
    row_of = {int(f): i for i, f in enumerate(a["fid"])}
    for j, f in enumerate(b["fid"]):
        i = row_of.get(int(f))
        if i is None:
            continue
        diffs = [f"{key} {a[key][i]} vs {b[key][j]}"
                 for key in ("ok", "is_kf", "n_kf", "n_mp", "n_ml") if a[key][i] != b[key][j]]
        dT = float(np.abs(a["T"][i] - b["T"][j]).max())
        if dT > POSE_TOL:
            diffs.append(f"pose max|dT| {dT:.3e}")
        if diffs and first is None:
            first = int(f)
            print(f"FIRST DIFFERING FRAME {f}: " + "; ".join(diffs))
        if diffs or a["is_kf"][i] or b["is_kf"][j]:
            print(f"  frame {int(f)}: kf {int(a['is_kf'][i])}/{int(b['is_kf'][j])} inl"
                  f" {int(a['n_inl'][i])}/{int(b['n_inl'][j])} kf# {int(a['n_kf'][i])}/"
                  f"{int(b['n_kf'][j])} mp {int(a['n_mp'][i])}/{int(b['n_mp'][j])} ml"
                  f" {int(a['n_ml'][i])}/{int(b['n_ml'][j])} |dT| {dT:.2e}"
                  + (" <-" if diffs else ""))
    ca, cb = a["cands"], b["cands"]
    for i in range(min(len(ca), len(cb))):
        if not np.array_equal(ca[i], cb[i]):
            print(f"FIRST DIFFERING DETECT CALL {i}: ref k={ca[i][0]} {ca[i][1:][ca[i][1:] >= 0]}"
                  f" port k={cb[i][0]} {cb[i][1:][cb[i][1:] >= 0]}")
            break
    else:
        print(f"detect calls: {len(ca)} / {len(cb)}, equal over the common prefix")
    return first


# ----------------------------------------------------------------- lockstep

class _Stop(Exception):
    pass


def lockstep(imgs, n: int, frontend_oracle: bool, probe: int):
    import jax.numpy as jnp
    import torch

    from structure_slam_pointline_tpu.models import pipeline as jpipe
    from structure_slam_pointline_tpu_torch import convert
    from structure_slam_pointline_tpu_torch.config import CameraConfig, SLAMConfig
    from structure_slam_pointline_tpu_torch.models import pipeline as tpipe
    from structure_slam_pointline_tpu_torch.utils.camera import Intrinsics

    torch.set_num_threads(1)
    tcfg = SLAMConfig(camera=CameraConfig(fy=480.0), enable_loop_closing=True)
    intr = Intrinsics.from_config(tcfg.camera)
    slam = _ref_system()
    step = slam._step_with_recovery

    def port_step(carry_np, img, fid, frame=None):
        """The port's slam_step from a numpy carry, optionally on a given frame."""
        build = tpipe.build_frame_device
        if frame is not None:
            tpipe.build_frame_device = lambda *a: convert.frame_from_numpy(frame, "cpu")
        try:
            return tpipe.slam_step(convert.carry_from_numpy(carry_np, "cpu"),
                                   torch.from_numpy(img), fid, intr, tcfg, True)
        finally:
            tpipe.build_frame_device = build

    def both(img_np, img_j, fid):
        if fid >= n:
            raise _Stop
        img = np.asarray(img_np, np.float32)
        jf = _numpy(jpipe.build_frame_device(jnp.asarray(img), slam.intr, slam.cfg))
        _print_frontends(fid, jf, tpipe.build_frame_device(torch.from_numpy(img), intr, tcfg))
        carry_np = _numpy(slam.carry)
        spy = _KeyframeSpy(tpipe, slam) if fid == probe else None
        try:
            c_out, o = port_step(carry_np, img, fid, jf if frontend_oracle else None)
        finally:
            if spy:
                spy.restore()
        T, ok, n_inl, is_kf = out = step(img_np, img_j, fid)
        slam.sync_cursors()
        c = slam.cur
        if spy and spy.k is not None:
            spy.after(slam, c_out)
            _, o2 = port_step(carry_np, img, fid,
                              dict(jf, ldesc=np.asarray(slam.carry.state.kf_ldesc[spy.k])))
            print(f"probe: the port's step with the whole step's line descriptors: n_ml "
                  f"{o2.n_ml} (reference {c.n_ml}), |dT| "
                  f"{np.abs(np.asarray(T) - o2.T_cw.numpy()).max():.2e}", flush=True)
        print(f"frame {fid}: ref/port kf {int(is_kf)}/{int(o.is_kf)} inl {n_inl}/{o.n_inliers}"
              f" n_kf {c.n_kf}/{o.n_kf} n_mp {c.n_mp}/{o.n_mp} n_ml {c.n_ml}/{o.n_ml} |dT|"
              f" {np.abs(np.asarray(T) - o.T_cw.numpy()).max():.2e}", flush=True)
        return out
    slam._step_with_recovery = both
    try:
        _stream(slam, imgs)
    except _Stop:
        pass


def _print_frontends(fid, jf: dict, tf):
    kv = jf["kp_valid"] & tf.kp_valid.numpy()
    lv = jf["line_valid"] & tf.line_valid.numpy()
    print(f"frame {fid} frontend: keypoints {int(jf['kp_valid'].sum())}/{int(tf.kp_valid.sum())},"
          f" xy differ {int((jf['xy'] != tf.xy.numpy())[kv].any(1).sum())}, desc differ"
          f" {int((jf['desc'].view(np.int32) != tf.desc.numpy())[kv].any(1).sum())}; lines"
          f" {int(jf['line_valid'].sum())}/{int(tf.line_valid.sum())}, endpoints max |d|"
          f" {float(np.abs(jf['line_ep'] - tf.line_ep.numpy())[lv].max(initial=0)):.2e},"
          f" ldesc words differ {int((jf['ldesc'].view(np.int32) != tf.ldesc.numpy())[lv].sum())}",
          flush=True)


class _KeyframeSpy:
    """Inside the port's keyframe step of the probed frame: the inputs of
    `insert_keyframe` and `create_new_lines`, and the reference's own
    functions, each jitted alone, run on them."""

    def __init__(self, tpipe, ref_slam):
        self.tpipe, self.ref = tpipe, ref_slam
        self.insert, self.new_lines = tpipe.lm.insert_keyframe, tpipe.lm.create_new_lines
        self.k = None
        tpipe.lm.insert_keyframe = self._insert
        tpipe.lm.create_new_lines = self._new_lines

    def restore(self):
        self.tpipe.lm.insert_keyframe = self.insert
        self.tpipe.lm.create_new_lines = self.new_lines

    def _insert(self, *a):
        out = self.insert(*a)
        _reference_chain(a, out, self.ref)
        return out

    def _new_lines(self, state, k, nbs, n_ml, intr, cfg):
        self.state, self.k, self.nbs, self.n_ml, self.intr, self.cfg = state, k, nbs, n_ml, intr, cfg
        return self.new_lines(state, k, nbs, n_ml, intr, cfg)

    def after(self, ref_slam, c_out):
        """The keyframe as the reference's whole jitted step stored it
        against the port's, and the lines one of them made."""
        k, n0 = self.k, self.n_ml
        for f in ("kf_ldesc", "kf_line_ep", "kf_line2d", "kf_line_valid", "kf_desc", "kf_xy"):
            r = np.asarray(getattr(ref_slam.carry.state, f)[k])
            v = getattr(c_out.state, f)[k].numpy()
            if r.dtype.kind == "f":
                print(f"  keyframe {k} {f}: whole step vs port max |d| "
                      f"{float(np.abs(r - v).max()):.3e}", flush=True)
                continue
            r = r.view(np.int32) if r.dtype == np.uint32 else r
            bad = np.nonzero(r != v)
            msg = f"  keyframe {k} {f}: {len(bad[0])} entries differ, rows {bad[0][:8]}"
            if f.endswith("desc") and len(bad[0]):
                bits = [int(bad[1][i]) * 32 + int(np.log2(int(np.uint32(x ^ y))))
                        for i, (x, y) in enumerate(zip(r[bad][:8].view(np.uint32),
                                                       v[bad][:8].view(np.uint32)))]
                msg += f", descriptor bits {bits}"
            print(msg, flush=True)
        made_j = np.asarray(ref_slam.carry.state.kf_line_ml[k]) >= n0
        made_t = c_out.state.kf_line_ml[k].numpy() >= n0
        print(f"probe: keyframe {k} lines made by the reference's whole jitted step "
              f"{np.nonzero(made_j)[0]}, by the port {np.nonzero(made_t)[0]}", flush=True)
        for f in np.nonzero(made_j != made_t)[0]:
            print(f"  line {f}: port {'made' if made_t[f] else 'none'}, reference "
                  f"{'made' if made_j[f] else 'none'}", flush=True)
            self._gates(int(f))

    def _gates(self, f: int):
        """Per neighbour of the probed keyframe: line f's match, the MAD
        margin gate and `create_new_lines`' gates in float64, on the port's
        input state."""
        from structure_slam_pointline_tpu_torch import convert
        from structure_slam_pointline_tpu_torch.ops import matching

        state, k, intr, cfg = self.state, self.k, self.intr, self.cfg
        d = convert.map_state_to_numpy(state)
        T1 = d["kf_T_cw"][k].astype(np.float64)
        c1 = -T1[:3, :3].T @ T1[:3, 3]
        Kc = intr.K("cpu").numpy().astype(np.float64)
        free1 = state.kf_line_valid[k] & (state.kf_line_ml[k] < 0)
        for nb in sorted({int(x) for x in self.nbs.tolist() if x >= 0}):
            free2 = state.kf_line_valid[nb] & (state.kf_line_ml[nb] < 0)
            m = matching.masked_match(state.kf_ldesc[k], state.kf_ldesc[nb][None],
                                      (free1[:, None] & free2[None, :])[None],
                                      max_dist=cfg.matching.th_high)
            valid = matching.mad_margin_gate(m, scale=cfg.matching.line_mad_ratio)
            j = int(m.idx[0, f])
            T2 = d["kf_T_cw"][nb].astype(np.float64)
            pi2 = d["kf_line2d"][nb][j].astype(np.float64) @ (Kc @ T2[:3, :4])
            ends = []
            for uv in (d["kf_line_ep"][k][f][:2], d["kf_line_ep"][k][f][2:]):
                ray = T1[:3, :3].T @ np.array([(uv[0] - intr.cx) / intr.fx,
                                               (uv[1] - intr.cy) / intr.fy, 1.0])
                lam = -(pi2[:3] @ c1 + pi2[3]) / (pi2[:3] @ ray)
                X = c1 + ray * lam
                ends.append((lam, (T1[:3, :3] @ X + T1[:3, 3])[2], X))
            (ls, zs, Xs), (le, ze, Xe) = ends
            seg = np.linalg.norm(Xe - Xs)
            print(f"    nb {nb}: match {j}, Hamming {int(m.dist[0, f])}, MAD gate "
                  f"{bool(valid[0, f])} | lam {ls:.6g} {le:.6g} | depth_ratio - 0.3 = "
                  f"{min(zs, ze) / max(zs, ze) - 0.3:.3e} | 1.3 mid_depth - seg_len = "
                  f"{0.65 * (zs + ze) - seg:.3e}", flush=True)


def _reference_chain(args, port_state, ref_slam):
    """The reference's keyframe pipeline up to `create_new_lines`, each
    function jitted alone, from the port's `insert_keyframe` inputs: how far
    its inserted keyframe is from the port's, and its point and line
    counts."""
    import jax
    import jax.numpy as jnp

    from structure_slam_pointline_tpu.models import local_mapping as jlm
    from structure_slam_pointline_tpu.models import tracking as jtrk
    from structure_slam_pointline_tpu.world import map_store as jms
    from structure_slam_pointline_tpu_torch import convert

    state, k, frame_id, T_cw, frame, feat_mp, line_ml, _ = args
    jst = jms.MapState(**{f: jnp.asarray(v)
                          for f, v in convert.map_state_to_numpy(state).items()})
    jfr = jtrk.Frame(**{f: jnp.asarray(v) for f, v in convert.frame_to_numpy(frame).items()})
    cfg, intr = ref_slam.cfg, ref_slam.intr
    st = jlm.insert_keyframe(jst, jnp.asarray(k), jnp.asarray(frame_id),
                             jnp.asarray(T_cw.numpy()), jfr, jnp.asarray(feat_mp.numpy()),
                             jnp.asarray(line_ml.numpy()), cfg)
    port = convert.map_state_to_numpy(port_state)
    for f, v in _numpy(st).items():
        e = (float(np.abs(v - port[f]).max()) if v.dtype.kind == "f" and v.size
             else float((v != port[f]).sum()))
        if e > 0:
            print(f"  reference insert_keyframe {f}: differs from the port's by {e:.3e}",
                  flush=True)
    top_w, top_n = jax.lax.top_k(jms.covisibility_weights(st, jnp.asarray(k)), 4)
    nbs = jnp.where(top_w > 0, top_n, jnp.maximum(k - 1 - jnp.arange(4), 0))
    out = jlm.create_new_points(st, jnp.asarray(k), nbs, jnp.asarray(int(ref_slam.carry.n_mp)),
                                intr, cfg)
    outl = jlm.create_new_lines(out.state, jnp.asarray(k), nbs,
                                jnp.asarray(int(ref_slam.carry.n_ml)), intr, cfg)
    print(f"probe: the reference's functions, each jitted alone, on the port's inputs: "
          f"neighbours {np.asarray(nbs).tolist()}, {int(out.n_new)} points, "
          f"{int(outl.n_new)} lines", flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", choices=("ref", "port"))
    ap.add_argument("--out", default="out_loop_trace")
    ap.add_argument("--lbd-oracle", action="store_true")
    ap.add_argument("--compare", nargs=2, metavar=("REF", "PORT"))
    ap.add_argument("--lockstep", type=int, default=0, metavar="N")
    ap.add_argument("--frontend-oracle", action="store_true")
    ap.add_argument("--probe", type=int, default=-1, metavar="F")
    args = ap.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if args.lockstep:
        lockstep(scenario()[0], args.lockstep, args.frontend_oracle, args.probe)
        return
    if not args.side:
        ap.error("--side, --compare or --lockstep")
    imgs, _ = scenario()
    trace, extra = run_ref(imgs) if args.side == "ref" else run_port(imgs, args.lbd_oracle)
    os.makedirs(args.out, exist_ok=True)
    name = args.side + ("_oracle" if args.lbd_oracle else "")
    trace.save(os.path.join(args.out, name + ".npz"), extra)
    print(f"{name}: {len(trace.rows)} frames in {extra['seconds']:.0f} s -> {args.out}/{name}.npz")


if __name__ == "__main__":
    main()
