"""The port's CUDA kernels against their plain versions, on the card.

This file imports nothing of JAX, so it also runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest tests/test_torch_port_cuda.py --noconftest -m cuda

Where CUDA is unavailable (the CPU test run) the tests skip.
"""

import numpy as np
import pytest
import torch

from structuredetector_tpu_torch.ops.kernels import (
    sigmoid_nms,
    sigmoid_nms_reference,
    sigmoid_nms_topk,
    sigmoid_nms_topk_reference,
)


def _logits(rng, *shape):
    return torch.from_numpy(rng.normal(0, 3, shape).astype(np.float32)).cuda()


def _edge_cases(rng):
    """(planes, k) on the card where the tiling of kernels A, B and C
    (32-wide, 64-tall tiles) has edges to get wrong: ragged tiles, a plateau
    across a tile border, k above a tile's pixels on a plane with one peak,
    a 256x256 plane and one of more than 32 tiles, a 1x1 plane; a
    saturated background with one peak, the select's plateau path; and
    thin planes (1x4096, 4096x1, 65536x1), on which a layout sized by rows
    or by 64x32 tiles breaks. 33x65 and 1x1 give kernel C clusters in
    which some blocks own no tile."""
    border = _logits(rng, 2, 128, 128)
    border[:, 60:68, 28:36] = 20.0  # clamps to 1 - 1e-6: one plateau over 4 tiles
    yy, xx = np.mgrid[0:128, 0:128]
    cone = (5.0 - np.hypot(yy - 70, xx - 40) / 20.0).astype(np.float32)
    saturated = torch.full((2, 128, 128), -20.0, device="cuda")  # clamps to 1e-6
    saturated[0, 10, 12] = saturated[1, 100, 70] = 2.0
    return [
        (saturated, 40),
        (_logits(rng, 3, 33, 65), 9),
        (_logits(rng, 3, 40, 72), 9),
        (border, 40),
        (torch.from_numpy(np.stack([cone, cone.T])).cuda(), 2100),
        (_logits(rng, 4, 256, 256), 40),
        (_logits(rng, 2, 65, 1008), 40),
        (_logits(rng, 3, 1, 1), 1),
        (_logits(rng, 2, 1, 4096), 40),
        (_logits(rng, 2, 4096, 1), 40),
        (_logits(rng, 1, 65536, 1), 40),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["rounds", "onehot"])
def test_kernels_bit_exact_on_card(variant):
    """Built from csrc/ with nvcc; each kernel equals its plain version
    bit for bit at the serving shapes, at a plane count that is not a
    multiple of 8, on an all-equal plane, on non-square planes, on a
    256x256 plane and on the tiling's edge cases. Both top-k variants,
    kernel B ("rounds") and kernel C ("onehot"), have one plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.default_rng(926354916)
    x = _logits(rng, 32, 3, 128, 128)
    torch.testing.assert_close(sigmoid_nms(x), sigmoid_nms_reference(x), rtol=0, atol=0)
    cases = [((64, 128, 128), 20), ((32, 128, 128), 40), ((100, 128, 128), 20),
             ((3, 40, 72), 9), ((4, 256, 256), 40)]
    for planes, k in [(_logits(rng, *shape), k) for shape, k in cases] + _edge_cases(rng):
        got = sigmoid_nms_topk(planes, k, variant=variant)
        want = sigmoid_nms_topk_reference(planes, k)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    flat = torch.zeros((2, 128, 128), device="cuda")
    _, inds = sigmoid_nms_topk(flat, 40, variant=variant)
    assert inds.cpu().tolist() == [list(range(40))] * 2
    vals, inds = sigmoid_nms_topk(torch.zeros((0, 128, 128), device="cuda"), 20,
                                  variant=variant)
    assert vals.shape == inds.shape == (0, 20)
    # k = H * W: every peak, then every zero in ascending index, until
    # each row is spent
    planes = _logits(rng, 2, 40, 72)
    got = sigmoid_nms_topk(planes, 40 * 72, variant=variant)
    for g, w in zip(got, sigmoid_nms_topk_reference(planes, 40 * 72)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.cuda
def test_sigmoid_nms_bit_exact_on_tile_edges():
    """Kernel A on the planes of the tiling's edge cases."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    for planes, _ in _edge_cases(np.random.default_rng(7)):
        x = planes.unsqueeze(1)
        torch.testing.assert_close(sigmoid_nms(x), sigmoid_nms_reference(x), rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "hwk,slots",
    [
        ((128, 128, 20), 8 * 20),  # 2 x 4 tiles of 64 x 32
        ((128, 128, 2100), 8 * 2048),  # k above a tile's pixels
        ((40, 72, 9), 3 * 9),
        ((33, 65, 33 * 65), 3 * 33 * 32),
        ((256, 256, 40), 32 * 40),
        ((65, 1008, 40), 64 * 40),  # more tiles than a warp has lanes
        ((1, 1, 1), 1),
    ],
)
def test_candidate_slots_on_card(hwk, slots):
    """Kernel B's candidate buffer a plane: tiles x min(k, pixels of a
    full tile), from the library that owns the tiling."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from structuredetector_tpu_torch.ops.kernels._build import load

    assert load("sigmoid_nms_topk").sdnet_topk_candidate_slots(*hwk) == slots


@pytest.mark.cuda
def test_topk_variant_launch_counts_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    before = dict(sigmoid_nms_topk.launches_by_variant)
    planes = torch.zeros((3, 16, 16), device="cuda")
    sigmoid_nms_topk(planes, 4, variant="onehot")
    sigmoid_nms_topk(planes, 4, variant="onehot")
    sigmoid_nms_topk(planes, 4)
    after = sigmoid_nms_topk.launches_by_variant
    assert after["onehot"] - before["onehot"] == 2
    assert after["rounds"] - before["rounds"] == 1


@pytest.mark.cuda
def test_rowmax_is_one_launch_a_call():
    """Kernel C is one kernel launch a call on every plane shape it takes,
    thin and partial clusters included: no scratch buffer, no second
    phase. Counted from a torch.profiler (CUPTI) trace of the card, as
    chip_smoke.kernel_trace reads it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(5)
    shapes = [((64, 128, 128), 20), ((4, 256, 256), 40), ((1, 65536, 1), 40),
              ((2, 1, 4096), 40), ((3, 33, 65), 9), ((3, 1, 1), 1)]
    inputs = [(_logits(rng, *shape), k) for shape, k in shapes]
    for x, k in inputs:
        sigmoid_nms_topk(x, k, variant="onehot")  # build and warm up
    torch.cuda.synchronize()
    for x, k in inputs:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                sigmoid_nms_topk(x, k, variant="onehot")
            torch.cuda.synchronize()
        names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
        assert len(names) == 3, (tuple(x.shape), names)
        assert all("rowmax_topk_kernel" in name for name in names), names


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu():
    """One fp32 train step (64x64, fpn_depth 32, batch 8, TF32 off in the
    forward and the backward) from the same weights on the card and on the
    CPU: the loss within 1e-4 relative, the whole gradient within 1e-2 in
    relative L2 norm (float32 gradients of this net already part from a
    float64 evaluation by up to 0.64 % a tensor on the CPU), the BN running
    statistics within 1e-4. Then a bf16 step with device augmentation on
    uint8 images gives a finite loss."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.train.state import create_train_state
    from structuredetector_tpu_torch.train.steps import train_step

    cfg = Config(width=64, height=64, fpn_depth=32, use_amp=False).set_labels(
        ["bean", "maize"], ["leaf"])
    rng = np.random.default_rng(3)
    kp = {
        "anchors_xy": rng.uniform(0, 15.75, (8, cfg.max_objects, 2)).astype(np.float32),
        "anchor_cls": rng.integers(0, 2, (8, cfg.max_objects)).astype(np.int32),
        "anchor_mask": rng.random((8, cfg.max_objects)) < 0.3,
        "parts_xy": rng.uniform(0, 15.75, (8, cfg.max_parts, 2)).astype(np.float32),
        "part_kind": np.zeros((8, cfg.max_parts), np.int32),
        "part_owner_xy": rng.uniform(0, 15.75, (8, cfg.max_parts, 2)).astype(np.float32),
        "part_mask": rng.random((8, cfg.max_parts)) < 0.3,
    }
    images = rng.normal(0, 1, (8, 64, 64, 3)).astype(np.float32)
    out = {}
    for device in ("cuda", "cpu"):
        model = init_model(cfg).to(device)
        state = create_train_state(cfg, model, steps_per_epoch=100)
        stats = train_step(state, torch.from_numpy(images).to(device),
                           {k: torch.from_numpy(v).to(device) for k, v in kp.items()}, cfg)
        out[device] = (float(stats["total_loss"]), model)
    (loss_gpu, gpu), (loss_cpu, cpu) = out["cuda"], out["cpu"]
    assert abs(loss_gpu - loss_cpu) <= 1e-4 * abs(loss_cpu)
    g = torch.cat([p.grad.cpu().flatten() for p in gpu.parameters()])
    c = torch.cat([p.grad.flatten() for p in cpu.parameters()])
    assert float((g - c).norm() / c.norm()) <= 1e-2
    for (name, a), (_, b) in zip(gpu.named_buffers(), cpu.named_buffers()):
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4)

    cfg.use_amp = True
    state = create_train_state(cfg, init_model(cfg).cuda(), steps_per_epoch=100)
    u8 = torch.from_numpy(rng.integers(0, 256, (8, 64, 64, 3), np.uint8)).cuda()
    stats = train_step(state, u8, {k: torch.from_numpy(v).cuda() for k, v in kp.items()}, cfg,
                       augment=True)
    assert np.isfinite(float(stats["total_loss"]))


@pytest.mark.cuda
def test_two_rank_train_step_on_card(tmp_path):
    """Data parallelism on the card: two ranks (gloo when they share one
    card, NCCL with a card each) run 3 fp32 steps with device augmentation
    at 32x32 on their halves of a global batch of 8 whose keypoint counts
    differ by rank (tests/torch_port_parallel_worker.py), against one
    process on the joined batch on the card. The ranks end identical; the
    first loss within 1e-4 (cuDNN may pick other fp32 algorithms at batch
    4 than at 8), the trajectory within 1e-3, the parameters within
    Adam's bound of 2 * lr a step (a noise-level gradient may take either
    sign, tests/test_torch_port_parallel.py)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # the tests directory is on sys.path (pytest's rootdir-less import);
    # a `tests` package elsewhere on the card host may shadow `tests.`
    from torch_port_parallel_worker import small_config, start_ranks, step_run

    parts = [p["augment"] for p in start_ranks(tmp_path, "step", device="cuda")()]
    cfg = small_config()
    want = step_run(cfg, "augment", "cuda")
    assert parts[0]["fingerprint"] == parts[1]["fingerprint"]
    got = parts[0]
    assert abs(got["losses"][0] - want["losses"][0]) <= 1e-4 * abs(want["losses"][0])
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-3)
    for key, value in want["state"].items():
        if key.endswith(("running_mean", "running_var", "num_batches_tracked")):
            continue
        gap = float((got["state"][key] - value).abs().max())
        assert gap <= 2 * cfg.learning_rate * len(want["losses"]), key


@pytest.mark.cuda
def test_model_axis_on_card(tmp_path):
    """The mesh's model axis on the card, two ranks sharing it over gloo: the
    1 x 2 tensor-parallel step (`--model_parallel 2`) at 32x32 on a global
    batch of 8, and the 1 x 2 row forward of a 32x32 batch of 4
    (tests/torch_port_parallel_worker.py's "card" case), against one
    process on the card. The ranks end identical; the loss within 1e-4
    and the gradient within 1e-4 of its largest element (cuDNN may pick
    other fp32 algorithms for the halved output channels and rows), the
    parameters within Adam's bound of 2 * lr; the row forward's maps
    within 1e-4 of their scale."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from structuredetector_tpu_torch.models.network import init_model
    from torch_port_parallel_worker import (
        GLOBAL_BATCH,
        ROW_INPUTS,
        forward_images,
        mesh_config,
        mesh_step,
        small_config,
        start_ranks,
        train_batch,
    )

    parts = start_ranks(tmp_path, "card", device="cuda")()
    cfg = small_config()
    want = mesh_step(cfg, None, *train_batch(cfg, GLOBAL_BATCH, 7, False), device="cuda")
    assert parts[0]["tp"]["fingerprint"] == parts[1]["tp"]["fingerprint"]
    got = parts[0]["tp"]
    assert abs(got["loss"] - want["loss"]) <= 1e-4 * abs(want["loss"])
    scale = max(float(g.abs().max()) for g in want["grad"].values())
    for key, value in want["grad"].items():
        assert float((got["grad"][key] - value).abs().max()) <= 1e-4 * scale, key
    for key, value in want["state"].items():
        if value.is_floating_point() and not key.endswith(("running_mean", "running_var")):
            assert float((got["state"][key] - value).abs().max()) <= 2 * cfg.learning_rate, key
    with torch.no_grad():
        plain = init_model(mesh_config()).cuda()(
            torch.from_numpy(forward_images(*ROW_INPUTS["rows_32"])).cuda().permute(0, 3, 1, 2))
    for r in parts:
        for key, value in plain.items():
            value = value.cpu()
            assert float((r["rows_32"][key] - value).abs().max() / value.abs().max()) <= 1e-4, key


@pytest.mark.cuda
@pytest.mark.parametrize("shape,cout,k", [((2, 64, 64, 64), 64, 3), ((1, 16, 16, 512), 512, 3),
                                          ((2, 32, 32, 128), 256, 1), ((1, 2, 2, 512), 512, 3),
                                          ((1, 4, 4, 256), 256, 1), ((1, 3, 5, 12), 20, 3)])
def test_int8_product_on_card_equals_cpu(shape, cout, k):
    """The int8 im2col + `torch._int_mm` on the card against the CPU's
    exact product (a float64 convolution of the same int8 values), at
    full int8 range: model shapes, maps of 16 pixels or fewer and of 15
    (each sample's rows padded to 32, which cuBLASLt's int8 GEMM needs),
    and K, N off multiples of 8."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from structuredetector_tpu_torch.models.quantize import int8_conv_nhwc, int8_conv_reference

    g = torch.Generator().manual_seed(sum(shape) + cout)
    x = torch.randint(-127, 128, shape, dtype=torch.int8, generator=g)
    w = torch.randint(-127, 128, (cout, shape[3], k, k), dtype=torch.int8, generator=g)
    stride, padding = (1, 1), (k // 2, k // 2)
    got = int8_conv_nhwc(x.cuda(), w.cuda(), stride, padding)
    assert got.dtype == torch.int32 and got.is_cuda
    assert torch.equal(got.cpu(), int8_conv_reference(x, w, stride, padding))
    assert torch.equal(got.cpu(), int8_conv_nhwc(x, w, stride, padding))


@pytest.mark.cuda
def test_export_predictor_on_card(tmp_path):
    """An int8 artifact with static scales, traced on the card: it runs
    there through `ExportPredictor` (dynamic batch, uint8 feed), its
    output equals the live graph's, and it refuses the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from PIL import Image

    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.export import (
        ArtifactDeviceError,
        export_model,
        load_exported,
        make_export_fn,
    )
    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.models.quantize import (
        calibrate_activation_scales,
        prequantize_variables,
    )
    from structuredetector_tpu_torch.predictor import ExportPredictor

    cfg = Config(width=128, height=128, fpn_depth=32, int8=True).set_labels(
        ["bean", "maize"], ["leaf"])
    model = init_model(cfg).cuda()
    rng = np.random.default_rng(2)
    cal = torch.from_numpy(rng.normal(0, 1, (4, 3, 128, 128)).astype(np.float32)).cuda()
    calibrate_activation_scales(model, [cal])
    path = export_model(cfg, model.state_dict(), tmp_path / "m.sdz", dynamic_batch=True,
                        fold_normalization=True, uint8_input=True, device="cuda")
    with pytest.raises(ArtifactDeviceError):
        load_exported(path, device="cpu")
    call, meta = load_exported(path, device="cuda")
    assert meta["int8"] and meta["platforms"] == ["cuda"]
    images = rng.integers(0, 256, (3, 128, 128, 3), np.uint8)
    got = call(images)
    graph = make_export_fn(prequantize_variables(model), 2, 1, fold_normalization=True).cuda()
    with torch.inference_mode():
        want = graph(torch.from_numpy(images).cuda())
    assert got.is_cuda and torch.equal(got, want)
    predictor = ExportPredictor(path)
    anns = predictor.predict_batch([Image.fromarray(a) for a in images])
    assert len(anns) == 3 and predictor.device.type == "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("variant", [dict(backbone="resnet18"), dict(backbone="resnet50"),
                                     dict(s2d_stem=True), dict(head_conv=16)],
                         ids=["resnet18", "resnet50", "s2d", "head_conv"])
def test_variant_forward_on_card_matches_cpu(variant):
    """A small fp32 model of each variant (64x64, fpn_depth 32, TF32 off)
    on the card and on the CPU from the same seeded weights: the head
    within 1e-4 of its scale; the bf16 forward on the card finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.models.network import init_model

    cfg = Config(width=64, height=64, fpn_depth=32, use_amp=False, **variant).set_labels(
        ["bean", "maize"], ["leaf"])
    x = torch.from_numpy(np.random.default_rng(4).normal(0, 1, (2, 3, 64, 64))
                         .astype(np.float32))
    with torch.inference_mode():
        cpu = init_model(cfg)(x, raw_output=True)
        gpu = init_model(cfg).cuda()(x.cuda(), raw_output=True).cpu()
        cfg.use_amp = True
        bf16 = init_model(cfg).cuda()(x.cuda(), raw_output=True)
    assert float((gpu - cpu).abs().max()) <= 1e-4 * float(cpu.abs().max())
    assert bf16.dtype == torch.float32 and bool(torch.isfinite(bf16).all())


@pytest.mark.cuda
def test_int8_resnet50_on_card_equals_cpu():
    """Every int8 conv of a small int8 resnet50 (bottleneck `conv3` and
    downsamples included) gives the CPU's int32 sums on the card, fed the
    same input (128x128: each map a multiple of 32 pixels or padded to it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.models.quantize import Int8Conv2d

    cfg = Config(width=128, height=128, fpn_depth=32, use_amp=False, int8=True,
                 backbone="resnet50").set_labels(["bean", "maize"], ["leaf"])
    model = init_model(cfg)
    inputs = {}

    def keep(name):
        def hook(module, args):
            inputs[name] = args[0]
        return hook

    for n, m in model.named_modules():
        if isinstance(m, Int8Conv2d):
            m.register_forward_pre_hook(keep(n))
    x = torch.from_numpy(np.random.default_rng(5).normal(0, 1, (2, 3, 128, 128))
                         .astype(np.float32))
    with torch.inference_mode():
        model(x)
        assert len(inputs) == 59
        for name, inp in inputs.items():
            m = model.get_submodule(name)
            want = m.accumulate(inp)[0]
            got = m.cuda().accumulate(inp.cuda())[0].cpu()
            assert torch.equal(got, want), name


def _graph_test_batch(cfg, size, b, seed):
    """uint8 images of `size` (w, h) and padded keypoints, each valid one
    on a grid cell of its own (no three gradients summed into one cell in
    an order that may vary)."""
    w, h = size
    gw, gh = int(w // cfg.down_ratio), int(h // cfg.down_ratio)
    rng = np.random.default_rng(seed)
    o, p = cfg.max_objects, cfg.max_parts
    cells = np.stack([rng.permutation(gw * gh)[:o + p] for _ in range(b)])
    # inside [0, grid - 1/4]: the grid coordinates of input pixels, which the flips keep
    xy = np.stack([cells % gw, cells // gw], -1) + rng.uniform(0.05, 0.7, (b, o + p, 2))
    xy = xy.astype(np.float32)
    kp = {"anchors_xy": xy[:, :o], "anchor_cls": rng.integers(0, 2, (b, o)).astype(np.int32),
          "anchor_mask": rng.random((b, o)) < 0.6, "parts_xy": xy[:, o:],
          "part_kind": np.zeros((b, p), np.int32),
          "part_owner_xy": xy[:, rng.integers(0, o, p)].astype(np.float32),
          "part_mask": rng.random((b, p)) < 0.8}
    images = rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)
    return (torch.from_numpy(images).cuda(),
            {k: torch.from_numpy(np.ascontiguousarray(v)).cuda() for k, v in kp.items()})


@pytest.mark.cuda
@pytest.mark.parametrize("backbone", ["resnet34", "swin_v2_b"])
def test_train_step_graphs_match_eager_on_card(backbone):
    """Whole-step CUDA graphs (`train/graphs.py`) against eager steps on the
    card, from one seeded state, on the ResNet-34 and the Swin V2-B
    encoder (whose stages 2-4 pad to the window in the 160x96 bucket):
    float32 (TF32 off) with device
    augmentation on uint8 images, 6 steps over two bucket sizes and a
    schedule boundary (the rate falls at step 3). Both buckets are
    captured ahead on the state as `Trainer.prewarm` does (a warm-up step
    on a copy, then the capture); the eager runs keep a forward pre-hook
    on the model, which keeps the step eager. cuDNN runs deterministic
    algorithms in every run (it has none for some bf16 backward
    convolutions, hence float32; the bf16 path is the benchmark's). The
    graphed run's stats, parameters, BatchNorm buffers, Adam's moments and
    the head its forward hook saw differ from the first eager run's by no
    more than twice the second eager run's difference from it (bit for
    bit where eager repeats itself bit for bit). The hook fires once a
    replay; the stats and heads handed back stay as they were after later
    replays of either bucket; 2 captures ahead, 2 more at the boundary, 6
    replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import copy

    from structuredetector_tpu_torch import tracing
    from structuredetector_tpu_torch.config import Config
    from structuredetector_tpu_torch.models.network import init_model
    from structuredetector_tpu_torch.train.state import TrainState, create_train_state, \
        make_optimizer
    from structuredetector_tpu_torch.train.steps import capture_train_step, train_step
    from structuredetector_tpu_torch.train.trainer import _zeros_batch

    cfg = Config(width=128, height=128, fpn_depth=32, use_amp=False, epochs=2,
                 lr_step=2, backbone=backbone).set_labels(["bean", "maize"], ["leaf"])
    sizes, order, b = {"a": (128, 128), "b": (160, 96)}, "ababba", 8
    batches = [_graph_test_batch(cfg, sizes[k], b, i) for i, k in enumerate(order)]
    seeded = init_model(cfg).cuda()
    cudnn = torch.backends.cudnn
    flags = cudnn.deterministic, cudnn.benchmark
    cudnn.deterministic, cudnn.benchmark = True, False
    before = tracing.train_graph_counters()
    try:
        runs = {}
        for name in ("eager1", "eager2", "graph"):
            state = create_train_state(cfg, copy.deepcopy(seeded), steps_per_epoch=3)
            if name == "graph":
                for size in sizes.values():
                    shadow = copy.deepcopy(state.model)
                    warm = TrainState(shadow, make_optimizer(shadow, state.lr_schedule(0)),
                                      state.lr_schedule)
                    images, kp = _zeros_batch(b, size[1], size[0], cfg, torch.uint8, "cuda")
                    train_step(warm, images, kp, cfg, augment=True)
                    assert capture_train_step(state, images, kp, cfg, shadow, augment=True)
            else:
                state.model.register_forward_pre_hook(lambda *a: None)
            heads = []
            state.model.register_forward_hook(lambda m, a, out: heads.append(out))
            stats, then = [], []
            for images, kp in batches:
                stats.append(train_step(state, images, kp, cfg, augment=True))
                then.append(({k: v.clone() for k, v in stats[-1].items()}, heads[-1].clone()))
            torch.cuda.synchronize()
            runs[name] = dict(state=state, stats=stats, heads=heads, then=then)
    finally:
        cudnn.deterministic, cudnn.benchmark = flags
    after = tracing.train_graph_counters()
    assert after["captures"] - before["captures"] == 4
    assert after["replays"] - before["replays"] == len(order)
    assert after["eager"]["first_use"] - before["eager"].get("first_use", 0) == 2
    assert after["eager"]["pre_hooks"] - before["eager"].get("pre_hooks", 0) == 2 * len(order)
    assert after["pool_bytes"] > before["pool_bytes"]

    graph = runs["graph"]
    assert len(graph["heads"]) == len(order)
    for (stats, head), got_stats, got_head in zip(graph["then"], graph["stats"], graph["heads"]):
        assert torch.equal(got_head, head)
        for k in stats:
            assert torch.equal(got_stats[k], stats[k]), k

    def quantities(run):
        state, opt = run["state"], run["state"].optimizer
        params = list(state.model.parameters())
        return {"stats": [v for s in run["stats"] for v in s.values()],
                "heads": [h.detach() for h in run["heads"]],
                "params": params, "buffers": list(state.model.buffers()),
                "exp_avg": [opt.state[p]["exp_avg"] for p in params],
                "exp_avg_sq": [opt.state[p]["exp_avg_sq"] for p in params],
                "adam_step": [opt.state[p]["step"] for p in params]}

    def gap(xs, ys):
        return max(float((x.detach().double() - y.detach().double()).abs().max())
                   for x, y in zip(xs, ys))

    e1, e2, g = (quantities(runs[n]) for n in ("eager1", "eager2", "graph"))
    gaps = {k: (gap(e2[k], e1[k]), gap(g[k], e1[k])) for k in e1}
    print("eager2 vs eager1, graph vs eager1:", gaps)
    for k, (eager_gap, graph_gap) in gaps.items():
        assert graph_gap <= 2 * eager_gap, (k, gaps)
