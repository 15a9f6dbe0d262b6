"""Shared by the port's training tests: the JAX package's scene draws,
rebuilt with its own ``split`` / ``uniform`` / ``normal`` calls in the order
``mav_detection_tpu.data.synthgen.generate_scene`` makes them, handed to the
port as ``SceneDraws``."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from mav_detection_tpu_torch.data.synthgen import MARGIN, SceneDraws, render_pad


def jax_scene_draws(key, h: int, w: int, pan_max: float = 0.0) -> dict:
    """The values ``generate_scene(key, h, w, pan_max=pan_max)`` draws, as
    numpy arrays keyed by ``SceneDraws`` field."""
    pad = render_pad(pan_max)
    H, W = h + 2 * pad, w + 2 * pad
    ks = jax.random.split(key, 20)
    U = jax.random.uniform

    def texture(k_noise, k_mix):
        kn, km, ksin = jax.random.split(k_mix, 3)
        return U(k_noise, (H, W)), U(kn, ()), U(ksin, (6,)), U(km, (2,))

    g = texture(ks[0], ks[13])
    s = texture(ks[1], ks[14])
    d = dict(ground_noise=g[0], ground_a=g[1], ground_sp=g[2], ground_u=g[3],
             sky_noise=s[0], sky_a=s[1], sky_sp=s[2], sky_u=s[3],
             horizon=U(ks[2], (), minval=0.2, maxval=0.45),
             foe=jnp.stack([U(ks[3], (), minval=0.2, maxval=0.8),
                            U(ks[4], (), minval=0.2, maxval=0.8)]),
             expansion=U(ks[5], (), minval=0.002, maxval=0.022),
             omega=U(ks[6], (3,), minval=-0.005, maxval=0.005),
             pan=U(ks[16], (2,), minval=-pan_max, maxval=pan_max),
             radius=U(ks[7], (), minval=3.0, maxval=14.0),
             pos=jnp.stack([U(ks[8], (), minval=MARGIN, maxval=1 - MARGIN),
                            U(ks[9], (), minval=MARGIN, maxval=1 - MARGIN)]),
             vel=U(ks[10], (2,), minval=-5.0, maxval=5.0),
             style=U(ks[15], (5,)), aug=U(ks[11], (4,)),
             normals=jax.random.normal(ks[12], (2, H, W)))
    return {k: np.asarray(v) for k, v in d.items()}


def port_draws(keys, h: int, w: int, pan_max: float = 0.0) -> SceneDraws:
    """``SceneDraws`` of a batch: one scene per JAX key."""
    per = [jax_scene_draws(k, h, w, pan_max) for k in keys]
    return SceneDraws(**{f: torch.from_numpy(np.stack([p[f] for p in per]))
                         for f in SceneDraws._fields})
