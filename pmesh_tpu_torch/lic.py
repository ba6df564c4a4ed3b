"""Line Integral Convolution visualization of vector RealFields.

Counterpart of ``pmesh_tpu/lic.py``: advect a texture along the stream
lines of a vector field by iterated readouts of every mesh point,
accumulating a kernel-weighted line integral, then paint the result
back to the mesh.
"""
import torch

from .window import FindResampler

__all__ = ["lic"]


def lic(vectors, kernel, length, ds, resampler=None, texture=None,
        normalize=True):
    """Line integral convolution.

    ``vectors`` is a list of RealFields (vx, vy, ...), ``kernel(s)`` the
    line kernel on s in [-1, 1], ``length``/``ds`` the line length and
    step in pixels; the texture defaults to native white noise of seed
    990919.  Returns a RealField.
    """
    pm = vectors[0].pm

    if normalize:
        vabs = sum(vi.value ** 2 for vi in vectors) ** 0.5
        vabs = torch.where(vabs == 0.0, 1.0, vabs)
        vectors = [pm.create(type='real', value=vi.value / vabs)
                   for vi in vectors]

    if texture is None:
        texture = pm.generate_whitenoise(seed=990919, type='real',
                                         compat='native')

    Q = pm.generate_uniform_particle_grid(shift=0.0)

    if resampler is None:
        resampler = pm.resampler
    resampler = FindResampler(resampler)

    f = texture.readout(Q, resampler='nearest')
    vmax = max(float(v.value.abs().max()) for v in vectors)

    for sign in [-1, +1]:
        x = Q
        s = 0.0
        while s < length * 0.5:
            k = kernel(s * sign / (length * 0.5))
            layout = pm.decompose(
                x, smoothing=vmax * ds * 0.5 + resampler.support * 0.5)
            dx = torch.stack(
                [v.readout(x, layout=layout, resampler=resampler) * ds
                 for v in vectors], dim=-1)
            x = x + dx * 0.5 * sign
            f = f + texture.readout(x, layout=layout,
                                    resampler=resampler) * k * ds
            x = x + dx * 0.5 * sign
            s += ds

    return pm.paint(Q, mass=f, resampler='nearest')
