"""PyTorch port, the megakernel's environment NEE (kernel K4): the plain
version against the JAX Pallas kernel in interpret mode (the oracle) on an
environment-only scene, as test_torch_env_kernel.py does and with its
tolerance and reasons (the oracle's approximate reciprocal, here also in
the escape's MIS weight against env NEE; XLA vs torch trigonometry; the
oracle's bilinear matrix product on XLA:CPU). The shared env rows are
drawn from the same threefry streams on both sides.

Measured on the development host (jax 0.9.0, torch 2.13.0 CPU), 64×64,
depth 3, 2 spp, 4096-px tiles, with ``pytest -s``: on the sun map 0.024%
of pixels above 1e-3 (one pixel, |Δ| 1.1e-2), with refraction and sobol
0.024% (|Δ| 3.6e-3); 46% bit-identical; channel means within 1.9e-6.
"""

import pytest
import torch

from test_torch_env_kernel import check_case, oracle_tiles  # noqa: F401

torch.set_num_threads(2)

CASES = {
    "env-nee": ("sun", None, dict(trace_depth=3, nee=True), "env_nee"),
    "env-nee-refraction-sobol": ("sun", None, dict(trace_depth=3, nee=True,
                                                   enable_refraction=True, sampler="sobol"),
                                 "refraction+env_nee"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_version_matches_oracle(case, tmp_path):
    kind, aperture, cfg, variant = CASES[case]
    check_case(kind, aperture, cfg, tmp_path, variant)
