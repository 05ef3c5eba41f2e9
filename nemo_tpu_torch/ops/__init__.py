"""Device operators: FFTs, solves, image filters, noise maps, painting."""

from . import fourier, hankel, imageops, interp, noise, paint, solve  # noqa: F401
