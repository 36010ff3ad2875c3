"""The check that decides `correct`: what the window produced against the
reference (``portbench/ref``), once the window has closed.

VolPath cells follow the program step by step from its own state: the
camera stage from each captured lane's (sample, pixel), each bounce from
the state the program handed that bounce, and the film conversion from the
program's final state; the film from the program's lanes. Preview cells
compare each sampled pixel's RGB end to end. Numbers compared:

- state_mismatch: the share of checks (a lane's camera stage, a lane's
  bounce, a lane's RGB) whose output differs from the reference's beyond
  the tolerances below, and of the carries between bounces (a lane's
  input to bounce d + 1 against its output of bounce d, bit for bit; a
  wavefront must run each depth once, in order);
- lane_mismatch (VolPath cells): the share of checked lanes with any such
  check off. A fault on the lanes of one material is off at one of a
  lane's checks (eleven at depth 5), so it moves state_mismatch by about
  a tenth of what it moves lane_mismatch;
- film_err: the largest relative gap between a sampled pixel of the film
  and the weighted sum of the lanes the program traced for it;
- samples_missing: (pixel, sample) pairs of the window absent from, or
  repeated in, the traced lanes.

The reference shades under material_coherence 'none', whatever the
cell's mode. `control=True` puts the reference, computed in bfloat16, in
the program's place (ref/bf16.py)."""

from __future__ import annotations

import numpy as np
import torch

from .capture import lane_key
from .ref import api as rapi
from .ref import stages
from .ref.bf16 import control as low_precision
from .scenes.build import build_scene, camera as make_camera

RTOL = 1e-3
ATOL = {"o": 1e-4, "prev_p": 1e-4, "d": 1e-4, "prev_ns": 1e-4, "lam": 1e-3,
        "beta": 1e-6, "r_u": 1e-6, "r_l": 1e-6, "L": 1e-6, "eta": 1e-6, "rgb": 1e-6}
COMPARED = ("o", "d", "beta", "r_u", "r_l", "L", "alive", "spec", "eta", "anyns",
            "prev_p", "prev_ns", "disp", "lam", "med")
CARRIED = COMPARED + ("px", "py", "si")
FILM_FLOOR = 1e-6


def lanes_off(a, b: dict, keys, exact: bool = False) -> torch.Tensor:
    """(n,) True where lane values of a differ from b's (the reference's)
    beyond the tolerances, or at all where exact; every lane where a is
    None (a control that gave no output)."""
    n = next(iter(b.values())).shape[0]
    bad = torch.zeros(n, dtype=torch.bool, device=next(iter(b.values())).device)
    if a is None:
        return ~bad
    for k in keys:
        x, y = a[k].reshape(n, -1), b[k].reshape(n, -1)
        if y.dtype.is_floating_point:
            x, y = x.double(), y.double()
            both_nan = torch.isnan(x) & torch.isnan(y)
            diff = (x != y) if exact else (x - y).abs() > ATOL.get(k, 1e-6) + RTOL * y.abs()
            bad |= ((diff | (torch.isnan(x) != torch.isnan(y))) & ~both_nan).any(1)
        else:
            bad |= (x != y).any(1)
    return bad


def ref_scene(spec, cfg, device):
    return build_scene(rapi, spec, cfg).build(device=device)


class Tally:
    def __init__(self):
        self.n = 0
        self.bad = 0
        self.parts = {}
        self.lanes = 0
        self.lanes_bad = 0
        self.lane_off = None

    def add(self, part: str, off: torch.Tensor):
        n, b = int(off.numel()), int(off.sum())
        self.n += n
        self.bad += b
        p = self.parts.setdefault(part, [0, 0])
        p[0] += b
        p[1] += n
        if self.lane_off is not None:
            # a check over other lanes than the wave's (lanes differ) is off at every lane
            self.lane_off |= off.to(self.lane_off.device) if off.shape == self.lane_off.shape \
                else True

    def start_lanes(self, n: int, device):
        """Count the checks that follow per lane too, until the next call."""
        self.close_lanes()
        self.lane_off = torch.zeros(n, dtype=torch.bool, device=device)

    def close_lanes(self):
        if self.lane_off is not None:
            self.lanes += self.lane_off.numel()
            self.lanes_bad += int(self.lane_off.sum())
            self.lane_off = None

    @property
    def share(self) -> float:
        """Mismatched checks over all; a run that checked nothing reads 1."""
        return self.bad / self.n if self.n else 1.0

    @property
    def lane_share(self) -> float:
        """Lanes with a mismatched check over the lanes checked, or 1."""
        self.close_lanes()
        return self.lanes_bad / self.lanes if self.lanes else 1.0


def volpath_checks(vp_fields: dict, cfg: dict, spec: dict, cap, films, device,
                   control: bool = False) -> tuple[dict, dict]:
    """(numbers, detail). films: [(rgb_sum (P, 3), weight_sum (P,), sample
    indices (set), first wavefront, end wavefront)] at the sampled pixels
    cap.pix, one per film the window filled."""
    rscene = ref_scene(spec, cfg, device)
    rcam = make_camera(rapi, cfg)
    # every coherence mode gives the same result per lane, so the program
    # under 'gated' or 'sorted' is held to the plain every-type dispatch
    vp = stages.VolPath(**dict(vp_fields, material_coherence="none"))
    tally = Tally()
    fallbacks = {"indices clamped": 0, "no output": 0}

    def low(fn, *args):
        out, moved = low_precision(fn, *args)
        if moved is None:
            fallbacks["no output"] += 1
        else:
            fallbacks["indices clamped"] += moved
        return out

    w, h = cap.pix.w, cap.pix.h

    def lanes_of(state, valid):
        """The valid lanes of a captured state, sorted by (sample, pixel)."""
        st = {k: v[valid] for k, v in state.items()}
        order = torch.argsort(lane_key(st["si"], st["px"], st["py"], w, h))
        return {k: v[order] for k, v in st.items()}

    for wave, rec in sorted(cap.bounces.items()):
        rec = sorted(rec, key=lambda r: r[0])
        st0 = lanes_of(rec[0][1], rec[0][3])
        key0 = lane_key(st0["si"], st0["px"], st0["py"], w, h)
        tally.start_lanes(key0.numel(), key0.device)
        ref0, _, pdf = stages.camera_state(vp, rscene, rcam, st0["si"], st0["px"], st0["py"])
        prog0 = st0
        if control:
            prog0 = low(stages.camera_state, vp, rscene, rcam, st0["si"], st0["px"], st0["py"])
            prog0 = prog0 and prog0[0]
        tally.add("camera", lanes_off(prog0, ref0, COMPARED))
        if [r[0] for r in rec] != list(range(vp.max_depth)):
            tally.add("bounces (not each depth once)", torch.ones_like(key0, dtype=torch.bool))
        last, prev_out = None, None
        for depth, s_in, s_out, valid in rec:
            s_in, s_out = lanes_of(s_in, valid), lanes_of(s_out, valid)
            if not torch.equal(lane_key(s_in["si"], s_in["px"], s_in["py"], w, h), key0):
                tally.add(f"bounce {depth} (lanes differ)", torch.ones_like(key0, dtype=torch.bool))
                prev_out = None
                continue
            if prev_out is not None and not control:
                # the loop hands each bounce what the last one returned, bit for bit
                tally.add(f"carry into {depth}", lanes_off(s_in, prev_out, CARRIED, exact=True))
            prev_out = s_out
            ref = stages.bounce(vp, rscene, rcam, depth, s_in)
            if control:
                s_out = low(stages.bounce, vp, rscene, rcam, depth, s_in)
            tally.add(f"bounce {depth}", lanes_off(s_out, ref, COMPARED))
            last = ref if control else s_out
        lanes = cap.lanes[wave]
        lk = lanes["key"][lanes["valid"]]
        lo = torch.argsort(lk)
        prog_rgb = lanes["rgb"][lanes["valid"]][lo]
        if last is None:
            tally.add("film rgb (no final state)", torch.ones_like(key0, dtype=torch.bool))
            continue
        ref_rgb = stages.film_rgb(vp, last["L"], last["lam"], last["disp"], pdf)
        if control:
            prog_rgb = low(stages.film_rgb, vp, last["L"], last["lam"], last["disp"], pdf)
        if lk.numel() != ref_rgb.shape[0] or not torch.equal(lk[lo], key0):
            tally.add("film rgb (lanes differ)", torch.ones(ref_rgb.shape[0], dtype=torch.bool))
        else:
            tally.add("film rgb", lanes_off(None if prog_rgb is None else {"rgb": prog_rgb},
                                            {"rgb": ref_rgb}, ("rgb",)))
    film_err, missing = film_checks(cap, films, control)
    numbers = {"state_mismatch": tally.share, "lane_mismatch": tally.lane_share,
               "film_err": film_err, "samples_missing": missing}
    detail = {"checks": tally.n, "lanes": f"{tally.lanes_bad}/{tally.lanes}",
              "bounce_waves": sorted(cap.bounces), "fallbacks": fallbacks,
              "parts": {k: f"{b}/{n}" for k, (b, n) in tally.parts.items()}}
    return numbers, detail


def film_checks(cap, films, control: bool):
    """film_err and samples_missing over every film of the window."""
    wh = cap.pix.w * cap.pix.h
    pix_id = (cap.pix.py * cap.pix.w + cap.pix.px).cpu().numpy()
    sorter = np.argsort(pix_id)
    p = pix_id.shape[0]
    worst, missing = 0.0, 0
    for rgb_sum, w_sum, samples, wa, wb in films:
        parts = [cap.lanes[wave] for wave in range(wa, wb)]
        v = np.concatenate([q["valid"].cpu().numpy() for q in parts])
        key = np.concatenate([q["key"].cpu().numpy() for q in parts])[v]
        rgbw = np.concatenate([(q["rgb"].double() * q["w"].double()[:, None]).cpu().numpy()
                               for q in parts])[v]
        w = np.concatenate([q["w"].double().cpu().numpy() for q in parts])[v]
        si, pid = key // wh, key % wh
        slot = sorter[np.searchsorted(pix_id, pid, sorter=sorter)]
        acc, acc_abs, acc_w = np.zeros((p, 3)), np.zeros((p, 3)), np.zeros(p)
        np.add.at(acc, slot, rgbw)
        np.add.at(acc_abs, slot, np.abs(rgbw))
        np.add.at(acc_w, slot, w)
        pairs, counts = np.unique(slot * (1 << 32) + si, return_counts=True)
        ok = (counts == 1) & np.isin(pairs % (1 << 32), np.asarray(sorted(samples)))
        missing += p * len(samples) - int(ok.sum()) + int((~ok).sum())
        if control:
            prog = torch.zeros((p, 3), dtype=torch.bfloat16)
            for s_idx in sorted(samples):
                m = si == s_idx
                step = np.zeros((p, 3))
                np.add.at(step, slot[m], rgbw[m])
                prog = (prog.float() + torch.from_numpy(step).float()).to(torch.bfloat16)
            prog = prog.double().numpy()
        else:
            prog = rgb_sum.double().cpu().numpy()
            werr = np.abs(w_sum.double().cpu().numpy() - acc_w) / (np.abs(acc_w) + FILM_FLOOR)
            worst = max(worst, float(werr.max(initial=0.0)))
        err = np.abs(prog - acc) / (acc_abs + FILM_FLOOR)
        worst = max(worst, float(err.max(initial=0.0)))
    return worst, (0 if control else missing)


def preview_checks(cfg, spec, cap, frames, ref_frames, device, control: bool = False):
    """frames: [(eye, seed, framebuffer values (P, 3) as read on the host)];
    ref_frames: the frame indices replayed by the reference."""
    rscene = ref_scene(spec, cfg, device)
    tally = Tally()
    fallbacks = {"indices clamped": 0, "no output": 0}
    for i in ref_frames:
        eye, seed, _ = frames[i]
        rcam = make_camera(rapi, cfg, eye=eye)
        ref = stages.preview_rgb(rscene, rcam, 0, seed, 1, cap.pix.px, cap.pix.py)
        if control:
            prog, moved = low_precision(stages.preview_rgb, rscene, rcam, 0, seed, 1,
                                        cap.pix.px, cap.pix.py)
            fallbacks["no output" if moved is None else "indices clamped"] += (
                1 if moved is None else moved)
        else:
            prog = cap.rgb[i]
        tally.add(f"frame {i}", lanes_off(None if prog is None else {"rgb": prog}, {"rgb": ref},
                                          ("rgb",)))
    worst, missing = 0.0, 0
    for i, (_, _, fb) in enumerate(frames):
        if i >= len(cap.rgb):
            missing += 1
            continue
        lanes = cap.rgb[i].double().cpu().numpy()
        if control:
            shown = torch.from_numpy(lanes).to(torch.bfloat16).double().numpy()
        else:
            shown = np.asarray(fb, np.float64)
        err = np.abs(shown - lanes) / (np.abs(lanes) + FILM_FLOOR)
        worst = max(worst, float(err.max(initial=0.0)))
    missing += max(0, len(cap.rgb) - len(frames))
    numbers = {"state_mismatch": tally.share, "film_err": worst, "samples_missing": missing}
    detail = {"checks": tally.n, "ref_frames": list(ref_frames), "fallbacks": fallbacks,
              "parts": {k: f"{b}/{n}" for k, (b, n) in tally.parts.items()}}
    return numbers, detail
