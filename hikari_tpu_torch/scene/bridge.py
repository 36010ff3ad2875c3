"""Carry a scene built by the JAX package over to the port.

``scene_from_numpy`` takes the JAX ``SceneData`` flattened to numpy arrays
(the caller does the flattening, so this module never imports JAX) and
returns the port's ``SceneData``, so both packages compute on the same BVH
leaf order and triangle indices.

Keys of ``arrays``: ``face_rows``, ``mat_type``, ``mat_idx``,
``world_lo``, ``world_hi``, ``scene_radius``, ``present_materials``,
``materials.<field>`` for every field of the port's ``MaterialBanks``,
``tex_rows``, ``alpha_const``, ``alpha_tex``, ``tri_p`` (the JAX package's
``bvh.p0 | p1 | p2``, concatenated), ``atlas.<field>`` for every field of
the ``TextureAtlas``,
``lights.<field>`` for every field of its ``LightBanks`` (the environment's
distribution as ``lights.env_dist.<field>``), ``light_bvh.<field>`` for
every field of the JAX package's ``LightBVH``, ``light_sampler``, and
either
``treelets.{lo,hi,sup_lo,sup_hi,bw,tri}`` (a flat scene) or
``inst.{lo,hi,bw,ti_obj,ti_inst,inst_a}``, ``inst_nrm``, ``inst_l2w`` and
``inst_mat_packed`` (an instanced scene). A scene with media adds
``media.<field>`` for every tensor field of the port's ``MediumBanks``,
``media.n_media``, ``media.has_grid``, ``media.has_brick``,
``media.has_deflection``,
``camera_medium`` and ``has_media``; without them the scene has no media.
Every ``bw`` is converted to
float32 by the caller; the instanced BLAS blocks always use the 3-way
split (``hikari_tpu/geometry/instanced.py:70-73``). ``has_alpha`` is the
port's own, from the real faces' alpha (the JAX package also counts the
zero alpha of an instanced BLAS's padding rows).
"""

from __future__ import annotations

from dataclasses import fields

import numpy as np
import torch

from ..geometry.instanced import InstancedTreelets
from ..geometry.wavefront import Treelets, coef_from_m4
from ..lights.bvh_sampler import LightBVH
from ..lights.types import LightBanks
from ..sampling.distributions import Distribution2D
from ..materials.types import MaterialBanks
from ..media.types import RGBGRID, MediumBanks, pack_media
from ..textures.atlas import TextureAtlas
from .scene import SceneData, surface_has_alpha


def coef_from_bw(bw: np.ndarray) -> np.ndarray:
    """Rebuild the float32 affine coefficients from the TPU layout.

    At SPLIT=3 the (T, 24, 3*TT) rows are [m1 m2 m1 m3 m1 m2] in blocks of
    4, where m1, m2, m3 are successive bf16 truncations of m, so
    (m1 + m2) + m3 == m exactly in float32."""
    bw = np.asarray(bw, np.float32)
    if bw.shape[1] != 24:
        raise ValueError(f"expected the 3-way split (24 rows), got {bw.shape}")
    m4 = (bw[:, 0:4] + bw[:, 4:8]) + bw[:, 12:16]
    return coef_from_m4(m4)


def scene_from_numpy(arrays: dict, device) -> SceneData:
    def t(key, dtype=None):
        x = torch.from_numpy(np.array(arrays[key]))
        return x if dtype is None else x.to(dtype)

    inst_kw = {}
    treelets = None
    if "inst.lo" in arrays:
        inst_kw = dict(
            inst=InstancedTreelets(
                lo=t("inst.lo"), hi=t("inst.hi"),
                coef=torch.from_numpy(coef_from_bw(arrays["inst.bw"])),
                ti_obj=t("inst.ti_obj", torch.int32), ti_inst=t("inst.ti_inst", torch.int32),
                inst_a=t("inst.inst_a")),
            inst_nrm=t("inst_nrm"), inst_l2w=t("inst_l2w"),
            inst_mat_packed=t("inst_mat_packed", torch.int32))
    else:
        treelets = Treelets(
            lo=t("treelets.lo"), hi=t("treelets.hi"), sup_lo=t("treelets.sup_lo"),
            sup_hi=t("treelets.sup_hi"),
            coef=torch.from_numpy(coef_from_bw(arrays["treelets.bw"])),
            tri=t("treelets.tri"))
    materials = MaterialBanks(**{f.name: t(f"materials.{f.name}")
                                 for f in fields(MaterialBanks) if f.name != "has_textures"},
                              has_textures=bool(arrays["materials.has_textures"]))
    alpha_const, alpha_tex = t("alpha_const"), t("alpha_tex", torch.int32)
    surface = dict(
        tex_rows=t("tex_rows"), alpha_const=alpha_const, alpha_tex=alpha_tex,
        tri_p=t("tri_p"),
        atlas=TextureAtlas(**{f.name: t(f"atlas.{f.name}") for f in fields(TextureAtlas)}),
        has_alpha=surface_has_alpha(alpha_const.numpy(), alpha_tex.numpy(),
                                    np.asarray(arrays["face_rows"])[:, 12] >= 0))
    light_kw = {}
    for f in fields(LightBanks):
        if f.name == "env_dist":
            light_kw[f.name] = Distribution2D(**{g.name: t(f"lights.env_dist.{g.name}")
                                                 for g in fields(Distribution2D)})
        elif f.name in ("area_flat_base", "n_flat"):
            light_kw[f.name] = int(arrays[f"lights.{f.name}"])
        elif f.name == "has_env":
            light_kw[f.name] = bool(arrays[f"lights.{f.name}"])
        else:
            light_kw[f.name] = t(f"lights.{f.name}")
    lights = LightBanks(**light_kw)
    media_kw = dict(media=pack_media([]))
    if "media.med_type" in arrays:
        flags = {"n_media": int, "has_grid": bool, "has_brick": bool, "has_deflection": bool}
        banks = {f.name: (flags[f.name](arrays[f"media.{f.name}"]) if f.name in flags
                          else t(f"media.{f.name}"))
                 for f in fields(MediumBanks) if f.name != "has_rgb"}
        banks["med_type"] = banks["med_type"].to(torch.int32)
        banks["has_rgb"] = bool((banks["med_type"] == RGBGRID).any())
        media_kw = dict(media=MediumBanks(**banks),
                        camera_medium=int(arrays["camera_medium"]),
                        has_media=bool(arrays["has_media"]))
    scene = SceneData(
        treelets=treelets, face_rows=t("face_rows"),
        mat_type=t("mat_type", torch.int32), mat_idx=t("mat_idx", torch.int32),
        materials=materials, lights=lights, light_bvh=_light_bvh(arrays),
        world_lo=t("world_lo"),
        world_hi=t("world_hi"), scene_radius=float(arrays["scene_radius"]),
        present_materials=tuple(int(x) for x in arrays["present_materials"]),
        n_lights=lights.n_flat, n_faces=int(arrays["face_rows"].shape[0]), **inst_kw,
        light_sampler=str(arrays["light_sampler"]), **media_kw, **surface)
    return scene.to(device)


def _light_bvh(arrays: dict) -> LightBVH:
    """The JAX package's LightBVH (``light_bvh.<field>``): its trails are
    uint32, its static counts numbers; the infinite lights' ids and the
    tree's depth follow from the per-light arrays."""
    kw = {f.name: torch.from_numpy(np.array(arrays[f"light_bvh.{f.name}"]))
          for f in fields(LightBVH) if f.name not in ("inf_ids", "n_infinite", "n_total",
                                                      "depth")}
    kw["light_trail"] = kw["light_trail"].to(torch.int64)
    in_bvh = np.asarray(arrays["light_bvh.light_in_bvh"], bool)
    inf_ids = np.nonzero(~in_bvh)[0].astype(np.int32)
    depth = np.asarray(arrays["light_bvh.light_depth"])[in_bvh]
    return LightBVH(**kw, inf_ids=torch.from_numpy(inf_ids if len(inf_ids)
                                                   else np.zeros(1, np.int32)),
                    n_infinite=int(arrays["light_bvh.n_infinite"]),
                    n_total=int(arrays["light_bvh.n_total"]),
                    depth=int(depth.max()) if len(depth) else 0)
