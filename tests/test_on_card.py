"""On-card checks: the kernels compiled for the GPU at real widths and the
end-to-end comparisons of chip_smoke.py, as tests.  They skip without a
GPU; on the card run them in one process:

    JAX_PLATFORMS=cuda,cpu python -m pytest tests/ -m gpu -p no:xdist
"""

import pytest

pytestmark = pytest.mark.gpu


def test_kernels_at_real_widths(gpu_device):
    import chip_smoke
    chip_smoke.phase1_dynamics()
    chip_smoke.phase1_reads()


def test_deployments_match_cpu(gpu_device):
    import chip_smoke
    chip_smoke.phase2(gpu_device.device_kind)
