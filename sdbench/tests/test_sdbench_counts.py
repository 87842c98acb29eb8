"""The analytic counts against published figures and the kernels' byte
bounds."""

import pytest

from sdbench import counts


@pytest.mark.parametrize("backbone,gmacs", [("resnet34", 3.6), ("resnet50", 4.1)])
def test_encoder_count_matches_the_published_figure(backbone, gmacs):
    """He et al. 2016 Table 1: 3.6 GMACs for ResNet-34 at 224x224; 4.1 for
    torchvision's ResNet-50 v1.5 (the paper's v1 reads 3.8)."""
    assert counts.encoder_macs(backbone, 224, 224) / 1e9 == pytest.approx(gmacs, rel=0.02)


def test_forward_flops_scale_with_pixels():
    a = counts.forward_flops("resnet34", 128, 7, 512, 512)
    b = counts.forward_flops("resnet34", 128, 7, 1024, 1024)
    assert b == pytest.approx(4 * a, rel=1e-9)
    assert counts.train_flops("resnet50", 128, 7, 384, 384) == 3 * counts.forward_flops(
        "resnet50", 128, 7, 384, 384)


def test_kernel_bytes_at_batch_32():
    """Kernel A 12.6 MB; kernel B 6.3 MB in and 20 KB out (K 20 over 64
    anchor planes, 40 over 32 part planes)."""
    assert counts.kernel_a_bytes(96, 128, 128) == 12582912
    b = counts.kernel_b_bytes(64, 128, 128, 20) + counts.kernel_b_bytes(32, 128, 128, 40)
    assert b == 96 * 128 * 128 * 4 + (64 * 20 + 32 * 40) * 8
    assert counts.decode_bytes(32, 2, 1, 128, 128, 20, 40) > 96 * 128 * 128 * 4
