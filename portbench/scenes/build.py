"""One scene description, built through either API: the program's
(``hikari_tpu_torch``) or the reference's (``portbench.ref.api``)."""

from __future__ import annotations

import importlib


def make_spec(cfg: dict) -> dict:
    """The configuration's scene arrays, from its maker
    ``portbench/scenes/<cfg["scene"]>.py``."""
    return importlib.import_module(f"portbench.scenes.{cfg['scene']}").make(cfg)


def _medium(api, medium):
    if medium is None:
        return None
    name, kw = medium
    return getattr(api, name)(**kw)


def _material(api, material):
    """api's material from (name, kwargs); a kwarg that is itself a
    (name, kwargs) pair, as a Mix child is, is built the same way."""
    name, kw = material
    nested = lambda v: (isinstance(v, tuple) and len(v) == 2 and isinstance(v[0], str)
                        and isinstance(v[1], dict))
    return getattr(api, name)(**{k: _material(api, v) if nested(v) else v
                                 for k, v in kw.items()})


def build_scene(api, spec: dict, cfg: dict):
    """api.Scene with the spec's meshes, media and lights (media shared by
    identity, as Scene dedupes them)."""
    s = api.Scene()
    media = {}
    for m in spec["meshes"]:
        arr = m["mesh"]
        mesh = api.TriangleMesh(arr["vertices"], arr["faces"], normals=arr["normals"],
                                uvs=arr["uvs"])
        med = m.get("inside_medium")
        if med is not None and id(med) not in media:
            media[id(med)] = _medium(api, med)
        s.add(mesh, _material(api, m["material"]),
              inside_medium=media.get(id(med)) if med is not None else None)
    for name, kw in spec["lights"]:
        s.add_light(getattr(api, name)(**kw))
    if spec["sunsky"] is not None:
        for light in api.sunsky_environment(direction=spec["sunsky"]):
            s.add_light(light)
    s.set_light_sampler(cfg.get("light_sampler", "power"))
    return s


def camera(api, cfg: dict, eye=None):
    c = cfg["camera"]
    return api.make_perspective_camera(tuple(eye if eye is not None else c["eye"]),
                                       tuple(c["look_at"]), tuple(cfg["resolution"]),
                                       fov_deg=c["fov_deg"])
