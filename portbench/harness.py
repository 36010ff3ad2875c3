"""Run one cell of the port's benchmark once and print its result line.

A cell (``workloads/<cell>.json``) names a configuration
(``configs/<config>.json``, whose scene ``scenes/<scene>.py`` makes) and a
traffic mix (``traffic/<traffic>.json``), which one general driver reads:

- ``wavefronts``: a final VolPath render. Each unit is one
  ``render_sample`` of ``sample_batch`` samples of every pixel into one
  film, ending in a device sync; sample indices continue, and a film that
  has taken ``samples_per_pixel`` samples is followed by a new one.
- ``frames``: an interactive viewport. Each unit is one frame of
  ``render_preview`` read to the host as a viewer shows it; the next frame
  starts when the last is on the host (a closed loop), and the camera
  swings about the look-at point at a fixed rate from a start drawn from
  the seed.

Set-up (scene arrays, scene build, one warm-up at the cell's shapes) runs
before the window; the window runs whole units and starts none it expects
to end after ``--seconds``. With ``--trace 1`` the window is a fixed number
of stage-timed units and then of profiled ones, and the line carries the
cell's per-layer metrics (``metrics/<metric>.py``) instead. Every run
checks, once the window has closed, what the timed path produced against
the plain reference (``check.py``)."""

from __future__ import annotations

import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import traceback
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from . import bound, check, profile_read
from .capture import PixelSet, PreviewCapture, VolPathCapture
from .scenes.build import build_scene, camera as make_camera, make_spec
from .timers import StageTimers

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "hikari_tpu")
SWEEPS = ("closest_tiles", "occlusion_tiles", "closest_pairs", "occlusion_pairs")


def process_start() -> float:
    """Wall-clock time this process started (from /proc), else now."""
    try:
        stat = Path("/proc/self/stat").read_text()
        ticks = int(stat.rsplit(")", 1)[1].split()[19])
        btime = next(int(line.split()[1]) for line in Path("/proc/stat").read_text().splitlines()
                     if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is JAX's or the JAX package's."""
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def smi_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi unavailable"


def load_cell(name: str, root: Path) -> dict:
    """The cell's manifest entry, its files, and the metrics it reports."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    entry = {w["name"]: w for w in manifest["workloads"]}.get(name)
    if entry is None:
        raise SystemExit(f"unknown workload {name!r}")
    bench = root / "portbench"
    cell = json.loads((bench / "workloads" / f"{name}.json").read_text())
    cfg = json.loads((bench / "configs" / f"{entry['config']}.json").read_text())
    traffic = json.loads((bench / "traffic" / f"{entry['traffic']}.json").read_text())
    traffic.update(cell.get("traffic_params", {}))
    mine = lambda m: name in m.get("workloads", [name])
    return dict(name=name, entry=entry, cell=cell, cfg=cfg, traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"] if mine(m)],
                per_layer=[m for m in manifest["per_layer"] if mine(m)])


def _target(spec: str):
    mod, fn = spec.split(":")
    return importlib.import_module(mod), fn


def stage_map() -> dict:
    data = json.loads((HERE / "stages.json").read_text())
    return {k: [_target(s) for s in v] for k, v in data.items() if not k.startswith("_")}


class SweepRecorder:
    """CUDA events around every sweep call of the profiled part, and what
    its bound needs: bytes at the call, the final bits and pair lists kept
    to count tests once the part is over."""

    def __init__(self, wf):
        self.wf = wf
        self.calls = []

    def _wrap(self, name, fn):
        def wrapped(*args):
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            out = fn(*args)
            e1.record()
            outs = out if isinstance(out, tuple) else (out,)
            final = (bound.closest_final_bits(outs[0]) if name.startswith("closest")
                     else bound.occlusion_final_bits(outs[0], args[2]))
            self.calls.append(dict(name=name, events=(e0, e1), final=final, tn_bits=args[5],
                                   seg=args[6], bytes=bound.call_bytes(args, outs)))
            return out
        return wrapped

    def __enter__(self):
        self.saved = [(n, getattr(self.wf, n)) for n in SWEEPS if hasattr(self.wf, n)]
        for n, fn in self.saved:
            setattr(self.wf, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved:
            setattr(self.wf, n, fn)

    def summary(self) -> list[dict]:
        torch.cuda.synchronize()
        out = []
        for c in self.calls:
            tests = bound.tests_from_final(c["final"], c["tn_bits"], c["seg"])
            out.append(dict(name=c["name"], ms=c["events"][0].elapsed_time(c["events"][1]),
                            bytes=c["bytes"], tests=tests,
                            bound_ms=bound.bound_ms(c["bytes"], tests)))
        return out


class Run:
    def __init__(self, info: dict, seed: int, device):
        self.cfg, self.traffic, self.cell = info["cfg"], info["traffic"], info["cell"]
        self.seed = int(seed)
        self.device = torch.device(device)
        self.cuda = self.device.type == "cuda"
        self.rng = np.random.default_rng([self.seed, 0x9E3779B9])
        self.render_seed = self.seed & 0xFFFFFFFF
        self.kind = self.traffic["kind"]
        self.w, self.h = self.cfg["resolution"]
        self.units = 0

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    # --- set-up --------------------------------------------------------------------

    def setup(self):
        import hikari_tpu_torch as hk
        from hikari_tpu_torch.integrators import preview, volpath

        self.hk, self.volpath, self.preview = hk, volpath, preview
        self.spec = make_spec(self.cfg)
        t0 = time.perf_counter()
        self.scene = build_scene(hk, self.spec, self.cfg).build(device=self.device)
        self.sync()
        self.build_s = time.perf_counter() - t0
        self.camera = make_camera(hk, self.cfg)
        chk = self.cell["check"]
        n_pix = min(chk["pixels"], self.w * self.h)
        flat = self.rng.choice(self.w * self.h, size=n_pix, replace=False)
        self.pixels = PixelSet(flat % self.w, flat // self.w, self.w, self.h, self.device)
        self.pix_host = (flat // self.w, flat % self.w)
        if self.kind == "wavefronts":
            self.vp_fields = dict(self.traffic["volpath"], max_depth=self.cfg["max_depth"],
                                  seed=self.render_seed)
            self.vp = hk.VolPath(**self.vp_fields)
            self.filt = hk.make_filter()
            self.films = []
            self._new_film()
            volpath.render_sample(self.vp, self.scene, self.camera,
                                  self.hk.make_film(self.w, self.h, device=self.device),
                                  self.filt, 0)
        else:
            orbit = self.traffic["orbit"]
            self.orbit_start = float(self.rng.uniform(0.0, 1.0))
            self.orbit_rate = float(orbit["cycles_per_frame"])
            self.frames = []
            self._frame(0, record=False)
        self.sync()

    def _new_film(self):
        self.film = self.hk.make_film(self.w, self.h, device=self.device)
        self.s_idx = 0
        self.films.append(dict(film=self.film, samples=set(), first=self.units, end=self.units))

    # --- units ---------------------------------------------------------------------

    def _eye(self, i: int):
        """The camera swings about the look-at point, a triangle wave of
        +-half_angle_deg at orbit_rate cycles a frame: a rate fixed in the
        mix, so that every seed's window sees the same views."""
        c = self.cfg["camera"]
        eye, at = np.asarray(c["eye"], np.float64), np.asarray(c["look_at"], np.float64)
        phase = (self.orbit_start + self.orbit_rate * i) % 1.0
        tri = 4.0 * abs(phase - 0.5) - 1.0
        ang = math.radians(self.traffic["orbit"]["half_angle_deg"]) * tri
        rel = eye - at
        x = rel[0] * math.cos(ang) + rel[2] * math.sin(ang)
        z = -rel[0] * math.sin(ang) + rel[2] * math.cos(ang)
        return (float(at[0] + x), float(eye[1]), float(at[2] + z))

    def _frame(self, i: int, record: bool = True):
        hk = self.hk
        eye = self._eye(i)
        cam = make_camera(hk, self.cfg, eye=eye)
        seed = (self.render_seed + 7919 * i) & 0xFFFFFFFF
        film = self.preview.render_preview(
            hk.FastWavefront(samples_per_pixel=self.traffic["samples_per_pixel"], seed=seed),
            self.scene, cam)
        fb = hk.framebuffer(film).cpu().numpy()
        if record:
            self.frames.append((eye, seed, fb[self.pix_host]))
        return self.traffic["samples_per_pixel"]

    def _wavefront(self):
        k = self.vp.sample_batch
        if self.s_idx + k > self.vp.samples_per_pixel:
            self._new_film()
        self.film = self.volpath.render_sample(self.vp, self.scene, self.camera, self.film,
                                               self.filt, self.s_idx)
        self.sync()
        rec = self.films[-1]
        rec["samples"].update(range(self.s_idx, self.s_idx + k))
        self.s_idx += k
        rec["end"] = self.units + 1
        return k

    def unit(self) -> int:
        """One unit of the traffic; returns the full-frame samples it completed."""
        n = self._wavefront() if self.kind == "wavefronts" else self._frame(self.units)
        self.units += 1
        return n

    # --- windows -------------------------------------------------------------------

    def _capture(self, bounce_waves):
        if self.kind == "wavefronts":
            return VolPathCapture(self.volpath, self.pixels, bounce_waves)
        return PreviewCapture(self.preview, self.pixels)

    def window(self, seconds: float, device_clock: bool = False):
        """Whole units until the next would be expected to end after `seconds`;
        with device_clock, under a CUDA-only profiler whose device busy time
        is read once the window has closed (device_busy_s)."""
        chk = self.cell["check"]
        waves = self.rng.choice(chk["bounce_wave_range"], size=chk["bounce_waves"],
                                replace=False) if self.kind == "wavefronts" else []
        self.samples, self.failed, self.attempted, self.unit_s = 0, 0, 0, []
        self.cap = self._capture(waves)
        clock = profile_read.DeviceClock() if device_clock and self.cuda else nullcontext()
        with self.cap, clock:
            t0 = time.perf_counter()
            while not self.unit_s or (time.perf_counter() - t0
                                      + statistics.fmean(self.unit_s)) <= seconds:
                self.attempted += 1
                ts = time.perf_counter()
                try:
                    self.samples += self.unit()
                except Exception:  # a unit that raises is counted and ends the window
                    traceback.print_exc()
                    self.failed += 1
                    break
                self.unit_s.append(time.perf_counter() - ts)
            self.window_s = time.perf_counter() - t0
        self.device_busy_s = (clock.busy_s() if isinstance(clock, profile_read.DeviceClock)
                              else None)

    def traced_window(self):
        """Stage-timed units, then plain units (neither timer nor profiler,
        timed whole on the host's clock), then profiled units."""
        tr = self.cell["trace"]
        chk = self.cell["check"]
        waves = (self.rng.choice(tr["stage_units"], size=min(chk["bounce_waves"],
                                                                   tr["stage_units"]),
                                 replace=False) if self.kind == "wavefronts" else [])
        self.samples, self.failed, self.attempted = 0, 0, 0
        self.cap = self._capture(waves)
        ctx = dict(build_s=self.build_s, cell=self.cell, cfg=self.cfg)
        with self.cap:
            timers = StageTimers(stage_map(), sync=self.cuda)
            t0 = time.perf_counter()
            with timers:
                n0 = self.samples
                for _ in range(tr["stage_units"]):
                    self.attempted += 1
                    self.samples += self.unit()
                self.sync()
            ctx.update(stage_s=dict(timers.secs), stage_calls=dict(timers.calls),
                       stage_wall_s=time.perf_counter() - t0, stage_samples=self.samples - n0)
            n0, t0 = self.samples, time.perf_counter()
            for _ in range(tr.get("plain_units", 0)):
                self.attempted += 1
                self.samples += self.unit()
            self.sync()
            ctx.update(plain_s=time.perf_counter() - t0, plain_samples=self.samples - n0)
            if self.cuda:
                from hikari_tpu_torch.geometry import sweep, wavefront

                sweep.reset_counts()
                rec = SweepRecorder(wavefront)
                n0 = self.samples
                acts = [torch.profiler.ProfilerActivity.CUDA, torch.profiler.ProfilerActivity.CPU]
                with torch.profiler.profile(activities=acts) as prof, rec:
                    t1 = time.perf_counter()
                    for _ in range(tr["profile_units"]):
                        self.attempted += 1
                        self.samples += self.unit()
                    self.sync()
                    part_s = time.perf_counter() - t1
                t2 = time.perf_counter()
                ctx.update(prof_samples=self.samples - n0, sweeps=rec.summary(),
                           device=profile_read.read(prof, part_s))
                print(f"[portbench] profiled part {part_s:.3f} s, profiler stop "
                      f"{t2 - t1 - part_s:.3f} s, trace read {time.perf_counter() - t2:.3f} s, "
                      f"sweep launches {dict(sweep.launches)}", file=sys.stderr)
        return ctx

    # --- the check ---------------------------------------------------------------------

    def release(self):
        """Drop the program's state before the reference runs."""
        for name in ("scene", "film", "camera"):
            self.__dict__.pop(name, None)
        if self.kind == "wavefronts":
            self.film_data = [
                (f["film"].rgb_sum[self.pixels.py, self.pixels.px].clone(),
                 f["film"].weight_sum[self.pixels.py, self.pixels.px].clone(),
                 f["samples"], f["first"], f["end"]) for f in self.films if f["end"] > f["first"]]
            self.films = []
        if self.cuda:
            torch.cuda.empty_cache()

    def check(self, control: bool = False):
        if self.kind == "wavefronts":
            return check.volpath_checks(self.vp_fields, self.cfg, self.spec, self.cap,
                                        self.film_data, self.device, control)
        if not hasattr(self, "ref_frames"):
            n = len(self.frames)
            self.ref_frames = sorted(self.rng.choice(
                n, size=min(self.cell["check"]["ref_frames"], n), replace=False).tolist())
        return check.preview_checks(self.cfg, self.spec, self.cap, self.frames, self.ref_frames,
                                    self.device, control)


def end_to_end(window_s: float, samples: int, unit_s: list, setup_s: float, names,
               busy_s: float | None = None) -> dict:
    """The cell's end-to-end metrics, each found by its base name (the part
    before a first '.', so a split such as sample_ms.preview reads the same
    quantity): sample_ms, the window's whole time over the full-frame
    samples it completed; device_ms, the seconds in which some operation ran
    on the card over the whole window (busy_s), over the same samples;
    frame_ms_p95, the 95th percentile of every unit's time (a frame, start
    to its image on the host); setup_s, process start to the window's
    start."""
    ms = [t * 1e3 for t in unit_s]
    value = {"sample_ms": (window_s * 1e3 / max(samples, 1), "ms"),
             "device_ms": (None if busy_s is None else busy_s * 1e3 / max(samples, 1), "ms"),
             "frame_ms_p95": ((statistics.quantiles(ms, n=100, method="inclusive")[94]
                               if len(ms) > 1 else ms[0]) if ms else None, "ms"),
             "setup_s": (setup_s, "s")}
    out = {}
    for name in names:
        v, unit = value[name.split(".")[0]]
        if v is not None:
            out[name] = {"value": v, "unit": unit}
    return out


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return all(numbers[k] <= limits[k] for k in limits), out


def read_metrics(info: dict, ctx: dict) -> dict:
    out = {}
    for m in info["per_layer"]:
        reader = importlib.import_module(f"portbench.metrics.{m['name'].split('.')[0]}")
        value = reader.read(ctx)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None, device=None, root: Path | None = None, overrides: dict | None = None,
         emit=print) -> int:
    """Run a cell. device / root / overrides serve the CPU tests: a device
    given skips the look for a card."""
    import argparse

    t_start = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    info = load_cell(args.workload, root or HERE.parent)
    for key, patch in (overrides or {}).items():
        info[key].update(patch)
    chips = info["entry"]["chips"]
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"no result: the cell needs {chips} CUDA device(s); "
                  f"torch.cuda.is_available()={torch.cuda.is_available()}, "
                  f"device_count={torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda"
    run = Run(info, args.seed, device)
    run.setup()
    setup_s = time.time() - t_start
    if args.trace:
        ctx = run.traced_window()
    else:
        run.window(args.seconds, device_clock=any(m["name"].split(".")[0] == "device_ms"
                                                   for m in info["end_to_end"]))
    failed = run.failed
    t_window_end = time.time()
    peak = torch.cuda.max_memory_allocated() if run.cuda else 0
    run.release()
    numbers, detail = run.check()
    t_check = time.time() - t_window_end
    ok, checks = judge(numbers, info["cell"]["limits"])
    found = forbidden_modules()
    if found:
        print(f"no result: JAX or the JAX package is loaded: {found}", file=sys.stderr)
        return 3
    if args.trace:
        metrics = read_metrics(info, ctx)
    else:
        metrics = end_to_end(run.window_s, run.samples, run.unit_s, setup_s,
                             [m["name"] for m in info["end_to_end"]], run.device_busy_s)
    name = torch.cuda.get_device_name(0) if run.cuda else "cpu"
    dev = {"platform": "gpu" if run.cuda else "cpu", "kind": name,
           "count": info["entry"]["chips"] if run.cuda else 0, "memory_peak_bytes": peak,
           "smi": smi_line() if run.cuda else "none"}
    result = {"correct": bool(ok and failed == 0), "attempted": run.attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if args.trace and ctx.get("device"):
        d = ctx["device"]
        dev.update(busy_s=d["busy_s"], window_s=d["window_s"])
        result["breakdown"] = {"device_ops": d["device_ops"], "idle_gaps": d["idle_gaps"]}
    print(f"[portbench] {args.workload} seed {args.seed}: units {run.units}, samples "
          f"{run.samples}, build {run.build_s:.3f} s, set-up {setup_s:.3f} s, window end at "
          f"{t_window_end - t_start:.3f} s, check {t_check:.3f} s, peak {peak / 2**30:.3f} GiB, "
          f"unit ms {[round(t * 1e3, 1) for t in getattr(run, 'unit_s', [])][:12]}, "
          f"check {json.dumps(detail)}", file=sys.stderr)
    if args.trace:
        print(f"[portbench] stages {json.dumps(ctx.get('stage_s'))} wall "
              f"{ctx.get('stage_wall_s')} samples {ctx.get('stage_samples')}", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    result["checks"] = checks
    emit(json.dumps(result))
    return 0
