"""Port parity: camera rays, filter sampling, wavelengths, colorimetry and
RGB uplifting. Inputs come from a numpy seed and go through both packages.

Tolerances: camera rays and filter offsets 1e-6 relative (float32 matrix
inverses and erfinv differ between the libraries in the last bits);
spectral quantities 1e-5 relative. Gaussian filter weights also get 1e-5
absolute: near the truncation radius the weight is a difference of two
nearly equal exponentials, so a last-bit change of the offset moves it by
up to ~1e-4 relative while staying within 1e-5 of a weight of ~1.5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hikari_tpu.camera import camera as jcam
from hikari_tpu.film import filters as jf
from hikari_tpu.spectral import cie as jcie
from hikari_tpu.spectral import rgb2spec as jr
from hikari_tpu.spectral import spectrum as jsp
from hikari_tpu_torch.camera import camera as tcam
from hikari_tpu_torch.film import filters as tf
from hikari_tpu_torch.spectral import cie as tcie
from hikari_tpu_torch.spectral import rgb2spec as tr
from hikari_tpu_torch.spectral import spectrum as tsp

RAY_RTOL = 1e-6
SPEC_RTOL = 1e-5


@pytest.mark.parametrize("eye,target,res,fov", [
    ((0.0, 1.6, -2.8), (0.0, 0.9, 2.0), (800, 800), 45.0),
    ((1.0, 2.0, -3.0), (0.2, 0.4, 0.5), (320, 200), 60.0),
])
def test_camera_rays(eye, target, res, fov):
    rng = np.random.RandomState(0)
    p_film = (rng.rand(4096, 2) * np.asarray(res)).astype(np.float32)
    zeros2 = np.zeros((4096, 2), np.float32)
    zeros1 = np.zeros(4096, np.float32)
    jc = jcam.make_perspective_camera(eye, target, res, fov_deg=fov)
    tc = tcam.make_perspective_camera(eye, target, res, fov_deg=fov)
    jo, jd = jc.generate_rays(jcam.CameraSample(
        p_film=jnp.asarray(p_film), lens=jnp.asarray(zeros2),
        time=jnp.asarray(zeros1), filter_weight=jnp.asarray(zeros1)))
    to, td = tc.generate_rays(tcam.CameraSample(
        p_film=torch.from_numpy(p_film), lens=torch.from_numpy(zeros2),
        time=torch.from_numpy(zeros1), filter_weight=torch.from_numpy(zeros1)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RAY_RTOL, atol=1e-6)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RAY_RTOL, atol=1e-6)


@pytest.mark.parametrize("ftype", [jf.BOX, jf.TRIANGLE, jf.GAUSSIAN])
def test_filter_sample(ftype):
    u = np.random.RandomState(1).rand(4096, 2).astype(np.float32)
    jo, jw = jf.filter_sample(jf.make_filter(ftype), jnp.asarray(u))
    to, tw = tf.filter_sample(tf.make_filter(ftype), torch.from_numpy(u))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RAY_RTOL, atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=SPEC_RTOL, atol=1e-5)


def test_wavelengths_and_xyz():
    rng = np.random.RandomState(2)
    u = rng.rand(4096).astype(np.float32)
    jwl = jsp.sample_wavelengths_visible(jnp.asarray(u))
    twl = tsp.sample_wavelengths_visible(torch.from_numpy(u))
    np.testing.assert_allclose(twl.lam.numpy(), np.asarray(jwl.lam), rtol=SPEC_RTOL)
    np.testing.assert_allclose(twl.pdf.numpy(), np.asarray(jwl.pdf), rtol=SPEC_RTOL)
    L = rng.rand(4096, 4).astype(np.float32) * 3
    lam, pdf = np.array(jwl.lam), np.array(jwl.pdf)
    jrgb = jcie.xyz_to_linear_srgb(jcie.spectral_to_xyz(
        jnp.asarray(L), jnp.asarray(lam), jnp.asarray(pdf)))
    trgb = tcie.xyz_to_linear_srgb(tcie.spectral_to_xyz(
        torch.from_numpy(L), torch.from_numpy(lam), torch.from_numpy(pdf)))
    # sRGB components are signed sums of XYZ terms of a few hundred: the
    # absolute slack is 1e-5 of the largest magnitude
    jrgb = np.asarray(jrgb)
    np.testing.assert_allclose(trgb.numpy(), jrgb, rtol=SPEC_RTOL,
                               atol=SPEC_RTOL * np.abs(jrgb).max())


def test_rgb2spec_uplift():
    rng = np.random.RandomState(3)
    rgb = rng.rand(2048, 3).astype(np.float32)
    rgb[:64] = rgb[:64, :1]            # gray special case
    rgb[64:96] = 0.0                   # black
    lam = (360.0 + rng.rand(2048, 4) * 470.0).astype(np.float32)
    jt, tt = jr.srgb_table(), tr.srgb_table()
    jl, tl = jnp.asarray(lam), torch.from_numpy(lam)
    jc, tc = jnp.asarray(rgb), torch.from_numpy(rgb)
    pairs = [
        (jr.albedo_coeff4(jt, jc), tr.albedo_coeff4(tt, tc)),
        (jr.unbounded_coeff4(jt, jc * 4.0), tr.unbounded_coeff4(tt, tc * 4.0)),
        (jr.rgb_albedo_eval(jt, jc, jl), tr.rgb_albedo_eval(tt, tc, tl)),
        (jr.rgb_unbounded_eval(jt, jc * 2.0, jl), tr.rgb_unbounded_eval(tt, tc * 2.0, tl)),
        (jr.rgb_illuminant_eval(jt, jc, jl), tr.rgb_illuminant_eval(tt, tc, tl)),
        (jr.coeff4_illuminant_eval(jr.unbounded_coeff4(jt, jc), jl),
         tr.coeff4_illuminant_eval(tr.unbounded_coeff4(tt, tc), tl)),
    ]
    for k, (j, t) in enumerate(pairs):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=SPEC_RTOL, atol=1e-5,
                                   err_msg=f"case {k}")
