"""The port's model axis on the CPU: output-channel tensor parallelism
(`--model_parallel`) and row (spatial) partitioning, over gloo groups of
2 and 4 ranks, against one process and against the JAX package.

One 2-rank group of `tests/torch_port_parallel_worker.py` runs the
"model_axis" case and one 4-rank group the "rows" case (the `runs`
fixture), a third `cli.train --model_parallel 2`. The ranks meet through
a `FileStore` in `tmp_path`, each with a timeout of its own. Meanwhile
this process runs JAX: the single-device `make_train_step`, the same
step over `create_mesh(1, 2)` (JAX's own tensor-parallel program) and
`make_forward`, on JAX tests/test_parallel.py's configuration (32x32,
`fpn_depth` 16, fp32, one label and one part kind: a 6-channel head) and
inputs, from JAX's init carried across by
`models.weights.state_dict_from_jax`, and JAX `make_sharded_forward` on
the same `create_mesh(1, 2)` (on `shard_variables` where the port's
model is sharded).

Bars: the loss of a step within 1e-5 relative (JAX's own between its
one-device and its sharded step); the first step's gradient within 1e-5
of the model's largest element of one process's where the BN layers see
the batch whole (1 x 2: the data group is one rank). Where the batch
splits over ranks (2 x 2) the BN statistics are sums of the ranks' sums,
and at this size (layer4 holds 2 values a channel a data rank) float32
gradients of either order depart from a float64 evaluation by up to
1e-4 of the largest element (one process 3.0e-5, the spatial step
3.7e-5, measured from the seeded init): there the gradient is held no
farther from the float64 one than twice the one process's distance (or
1e-5), and so are the BN statistics after the step (one process's
within 1e-5 of each tensor's largest element where the batch is
whole). The parameters after the step within Adam's bound 2 * lr (its
first update is about lr * sign(grad), and a gradient of rounding noise
takes either sign); the head bias within JAX's 1e-6 of JAX's
single-device step; the row forward's four maps within JAX's atol 1e-5
of JAX `make_forward` and of the port's one-process forward, and the
1 x 2 `make_sharded_forward`'s within it of JAX's on that mesh and of
the one-process forward. A fault
planted in the spatial backward (`FAULTS`: the halo gradients dropped,
the head output's gradient summed over the rows' ranks) must land
outside the spatial step's gradient bar.
"""

import functools
import json
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structuredetector_tpu.config import Config as JaxConfig
from structuredetector_tpu.models import init_model as jax_init_model
from structuredetector_tpu.models.network import load_params
from structuredetector_tpu.parallel.mesh import create_mesh as jax_create_mesh
from structuredetector_tpu.parallel.mesh import param_shardings as jax_param_shardings
from structuredetector_tpu.parallel.mesh import shard_variables as jax_shard_variables
from structuredetector_tpu.train.state import create_train_state as jax_create_train_state
from structuredetector_tpu.train.state import make_optimizer as jax_make_optimizer
from structuredetector_tpu.train.steps import make_forward as jax_make_forward
from structuredetector_tpu.train.steps import make_sharded_forward as jax_make_sharded_forward
from structuredetector_tpu.train.steps import make_train_step as jax_make_train_step
from structuredetector_tpu_torch.cli import evaluate as evaluate_cli
from structuredetector_tpu_torch.models.network import init_model
from structuredetector_tpu_torch.models.weights import (
    jax_tree_from_state_dict,
    state_dict_from_jax,
)
from structuredetector_tpu_torch.parallel import mesh as port_mesh
from structuredetector_tpu_torch.train.checkpoints import CheckpointManager
from structuredetector_tpu_torch.train.state import create_train_state
from structuredetector_tpu_torch.train.steps import make_sharded_forward, train_step
from tests.test_torch_port_evaluate import _write_images
from tests.torch_port_parallel_worker import (
    FAULTS,
    GLOBAL_BATCH,
    ROW_INPUTS,
    ROW_VARIANTS,
    TP_FORWARD_INPUTS,
    TP_FORWARDS,
    fingerprint,
    forward_images,
    jax_test_batch,
    mesh_config,
    mesh_step,
    rel_gap,
    small_config,
    start_ranks,
    train_batch,
)

LR = 1e-3  # mesh_config's and small_config's


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU runs (the suite runs in
    several worker processes at once)."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def jax_config(labels=("bean",), fpn_depth=16):
    """JAX's `make_config` of tests/test_parallel.py (`mesh_config`), or
    with `small_config`'s labels and width."""
    cfg = JaxConfig(width=32, height=32, max_objects=2, max_parts=4, fpn_depth=fpn_depth,
                    batch_size=4, use_amp=False)
    cfg.set_labels(list(labels), ["leaf"])
    return cfg


@functools.lru_cache(maxsize=None)
def jax_variables(labels, fpn_depth):
    """JAX's init of `jax_config(labels, fpn_depth)` as numpy leaves (one
    init a configuration for the module)."""
    return jax.tree.map(np.asarray, jax_init_model(jax_config(labels, fpn_depth))[1])


def as_jax(images, kp):
    return jnp.asarray(images), {k: jnp.asarray(v) for k, v in kp.items()}


# -- the mesh and the sharding rule, in one process ---------------------------


@pytest.mark.parametrize("data,model,world", [
    (4, 2, 8), (0, 2, 8), (8, 1, 8),  # JAX test_create_mesh_shapes
    (1, 2, 2), (0, 4, 4), (2, 2, 4), (0, 0, 3),
    (8, 2, 8),  # needs 16: both raise
])
def test_mesh_shape_matches_jax_create_mesh(data, model, world):
    """`mesh_shape` lays the ranks out as JAX `create_mesh` lays out as many
    devices, and raises where JAX does, naming the torchrun command."""
    try:
        want = dict(jax_create_mesh(data, model, devices=jax.devices()[:world]).shape)
    except ValueError:
        with pytest.raises(ValueError, match="torchrun --nproc_per_node 16"):
            port_mesh.mesh_shape(data, model, world)
        return
    got = port_mesh.mesh_shape(data, model, world)
    assert {"data": got[0], "model": got[1]} == want


def test_mesh_must_hold_every_rank():
    """JAX may leave devices out of a mesh; a rank of the port has no other
    work, so a mesh smaller than the world raises."""
    assert dict(jax_create_mesh(2, 1, devices=jax.devices()[:8]).shape) == {"data": 2,
                                                                          "model": 1}
    with pytest.raises(ValueError, match="torchrun --nproc_per_node 2 .*--data_parallel 2"):
        port_mesh.mesh_shape(2, 1, 8)


@pytest.mark.parametrize("labels,fpn_depth", [(("bean",), 16), (("bean", "maize"), 8)])
@pytest.mark.parametrize("model", [1, 2, 4])
def test_param_shardings_match_jax(labels, fpn_depth, model):
    """The port's rule over its state_dict names places on the model axis
    exactly the tensors that JAX `param_shardings` does (the head of
    M+N+4 = 6 channels shards over 2 ranks, of 7 it replicates), and a
    rank's share of the elements is JAX's per-device share."""
    variables = jax_variables(labels, fpn_depth)
    specs = jax_param_shardings(variables, jax_create_mesh(1, model,
                                                           devices=jax.devices()[:model]))
    sd = state_dict_from_jax(variables)
    names = set(port_mesh.param_shardings(sd, model))
    marks = jax_tree_from_state_dict({k: torch.full(v.shape, float(k in names))
                                      for k, v in sd.items() if v.is_floating_point()})
    for (path, spec), (mark_path, mark) in zip(jax.tree_util.tree_leaves_with_path(specs),
                                               jax.tree_util.tree_leaves_with_path(marks)):
        assert path == mark_path
        assert ("model" in tuple(spec.spec)) == bool(mark.all()), jax.tree_util.keystr(path)
        assert mark.all() or not mark.any()
    head_sharded = "head.conv.weight" in names
    assert head_sharded == (model > 1 and (len(labels) + 5) % model == 0)
    share = sum(v.size // model if "model" in tuple(s.spec) else v.size
                for v, s in zip(jax.tree.leaves(variables), jax.tree.leaves(specs)))
    port = sum(v.numel() // model if k in names else v.numel()
               for k, v in sd.items() if v.is_floating_point())
    assert port == share


# -- over 2 and 4 ranks -----------------------------------------------------


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The "model_axis" case on 2 ranks and the "rows" case on 4; meanwhile
    JAX's steps and forwards and the port's one-process runs."""
    tmp = tmp_path_factory.mktemp("model-axis")
    jcfg = jax_config()
    model, variables = jax_init_model(jcfg)  # the module; the variables are the cached init's
    variables = jax_variables(("bean",), 16)
    weights = state_dict_from_jax(variables)
    torch.save(weights, tmp / "weights.pt")
    wait_tp = start_ranks(tmp / "tp", "model_axis", tmp / "weights.pt", tmp / "ckpt")
    wait_rows = start_ranks(tmp / "rows", "rows", tmp / "weights.pt", world=4)

    cfg = mesh_config()
    images, kp = jax_test_batch(cfg, 4)
    opt = jax_make_optimizer(jcfg, 10)
    state = jax_create_train_state(jcfg, variables, opt)
    jax_runs = {}
    single, stats = jax_make_train_step(model, jcfg, opt, out_h=8, out_w=8, donate=False)(
        state, *as_jax(images, kp))
    jax_runs["single"] = (float(stats["total_loss"]), np.asarray(single.params["head"]["bias"]))
    mesh = jax_create_mesh(1, 2, devices=jax.devices()[:2])
    sharded, stats = jax_make_train_step(model, jcfg, opt, out_h=8, out_w=8, mesh=mesh,
                                         state_example=state, donate=False)(
        state, *as_jax(images, kp))
    jax_runs["mesh_1x2"] = (float(stats["total_loss"]), np.asarray(sharded.params["head"]["bias"]))
    forward = jax_make_forward(model)
    for name, (shape, seed) in ROW_INPUTS.items():
        jax_runs[name] = {k: np.transpose(np.asarray(v), (0, 3, 1, 2)) for k, v in  # NHWC
                          forward(variables, jnp.asarray(forward_images(shape, seed))).items()}
    sharded_variables = jax_shard_variables(variables, mesh)
    for name, (inputs, shard, spatial) in TP_FORWARDS.items():
        forward = jax_make_sharded_forward(model, mesh, spatial=spatial)
        maps = forward(sharded_variables if shard else variables,
                       jnp.asarray(forward_images(*TP_FORWARD_INPUTS[inputs])))
        jax_runs[f"forward_{name}"] = {k: np.transpose(np.asarray(v), (0, 3, 1, 2))
                                       for k, v in maps.items()}

    seeded = train_batch(small_config(), GLOBAL_BATCH, 7, False)
    one = {"jax_weights": mesh_step(cfg, None, images, kp, weights),
           "seeded": mesh_step(small_config(), None, *seeded),
           "seeded_resnet50": mesh_step(small_config(backbone="resnet50"), None, *seeded),
           "jax_weights_f64": float64_gradient(cfg, images, kp, weights),
           "seeded_f64": float64_gradient(small_config(), *seeded)}
    for name, (shape, seed) in ROW_INPUTS.items():
        model_one = init_model(cfg)
        model_one.load_state_dict(weights)
        one[name] = make_sharded_forward(model_one)(torch.from_numpy(forward_images(shape, seed)))
    for name, (shape, seed) in TP_FORWARD_INPUTS.items():
        model_one = init_model(cfg)
        model_one.load_state_dict(weights)
        one[f"forward_{name}"] = make_sharded_forward(model_one)(
            torch.from_numpy(forward_images(shape, seed)))
    for name, (overrides, inputs) in ROW_VARIANTS.items():
        one[name] = make_sharded_forward(init_model(mesh_config(**overrides)))(
            torch.from_numpy(forward_images(*ROW_INPUTS[inputs])))
    ranks = {"tp": wait_tp(), "rows": wait_rows()}
    yield {"ranks": ranks, "one": one, "jax": jax_runs, "tmp": tmp}
    shutil.rmtree(tmp)  # the weights and the checkpoint with Adam's moments


def float64_gradient(cfg, images, kp, weights=None):
    """The first step of one process with the network in float64 (the loss
    in float32): its gradient ("grad") and BN statistics ("stats")."""
    model = init_model(cfg)
    if weights is not None:
        model.load_state_dict(weights)
    state = create_train_state(cfg, model.double(), steps_per_epoch=10)
    train_step(state, torch.from_numpy(images).double(),
               {k: torch.from_numpy(v) for k, v in kp.items()}, cfg)
    return {"grad": {n: p.grad.float() for n, p in model.named_parameters()},
            "stats": {n: b.float() for n, b in model.named_buffers()
                      if n.endswith(("running_mean", "running_var"))}}


def _grad_gap(got, want):
    """max |got - want| over the gradient's largest element."""
    scale = max(float(g.abs().max()) for g in want.values())
    return max(float((got[k] - v).abs().max()) for k, v in want.items()) / scale


def _grad_bar(want, f64):
    """The gradient bar against the float64 step where the batch splits:
    twice one process's distance from it, or 1e-5."""
    return max(2 * _grad_gap(want["grad"], f64["grad"]), 1e-5)


def _held_to(got, want, f64=None):
    """A mesh step against one process on the whole batch: the loss within
    1e-5, the gradient within 1e-5 of the largest element and the BN
    statistics within 1e-5 of each tensor's largest (with `f64`: each no
    farther from the float64 step than twice one process's distance, or
    1e-5), the parameters within Adam's bound."""
    assert got["loss"] == pytest.approx(want["loss"], rel=1e-5)
    if f64 is None:
        assert _grad_gap(got["grad"], want["grad"]) <= 1e-5
    else:
        assert _grad_gap(got["grad"], f64["grad"]) <= _grad_bar(want, f64)
    for key, value in want["state"].items():
        if key.endswith(("running_mean", "running_var")):
            if f64 is None:
                assert rel_gap(got["state"][key], value) <= 1e-5, key
            else:
                near = f64["stats"][key]
                assert rel_gap(got["state"][key], near) <= max(
                    2 * rel_gap(value, near), 1e-5), key
        elif value.is_floating_point():
            assert float((got["state"][key] - value).abs().max()) <= 2 * LR, key
        else:
            assert torch.equal(got["state"][key], value), key


@pytest.mark.parametrize("run,one", [
    ("tp", "jax_weights"),  # 1 x 2, a 6-channel head: every conv sharded
    ("tp_head7", "seeded"),  # 1 x 2, a 7-channel head: replicated
    ("tp_resnet50", "seeded_resnet50"),  # 1 x 2, Bottleneck blocks
])
def test_tensor_parallel_step_matches_one_process(runs, run, one):
    """`--model_parallel 2`: the ranks agree, and rank 0's whole gradient
    and state equal one process's on the same batch."""
    parts = [r[run] for r in runs["ranks"]["tp"]]
    assert parts[0]["fingerprint"] == parts[1]["fingerprint"]
    assert parts[0]["loss"] == parts[1]["loss"]
    _held_to(parts[0], runs["one"][one])


def test_tensor_parallel_step_matches_jax(runs):
    """The 1 x 2 step from JAX's weights against JAX's single-device step
    and JAX's own step over `create_mesh(1, 2)`: loss within 1e-5; the
    head bias within JAX's 1e-6 of the single-device step's."""
    got = runs["ranks"]["tp"][0]["tp"]
    for name in ("single", "mesh_1x2"):
        loss, bias = runs["jax"][name]
        assert got["loss"] == pytest.approx(loss, rel=1e-5), name
        np.testing.assert_allclose(got["state"]["head.conv.bias"].numpy(), bias, atol=1e-6)


@pytest.mark.parametrize("labels,run", [(("bean",), "tp"), (("bean", "maize"), "tp_head7")])
def test_rank_holds_jax_per_device_share(runs, labels, run):
    """A rank's parameter and BN-statistic elements under `--model_parallel
    2` are what JAX `param_shardings` places on one device of a 1 x 2 mesh."""
    variables = jax_variables(labels, 16 if run == "tp" else small_config().fpn_depth)
    specs = jax_param_shardings(variables, jax_create_mesh(1, 2, devices=jax.devices()[:2]))
    for r in runs["ranks"]["tp"]:
        for part in ("params", "batch_stats"):
            share = sum(v.size // 2 if "model" in tuple(s.spec) else v.size
                        for v, s in zip(jax.tree.leaves(variables[part]),
                                        jax.tree.leaves(specs[part])))
            assert r[run]["elements"][part] == share, part


def test_model_axis_mesh_and_config_under_a_group(runs):
    """Under 2 ranks `Config(model_parallel=2).validate()` works, the mesh is
    1 x 2 (rank r at model index r, a data group of one), and a mesh that
    does not hold the 2 ranks raises naming the torchrun command."""
    parts = runs["ranks"]["tp"]
    assert [r["mesh"] for r in parts] == [(1, 2, 0, 0, 1, 2, "gloo"), (1, 2, 0, 1, 1, 2, "gloo")]
    for r in parts:
        errors = r["config_errors"]
        assert errors[1, 2] is None and errors[0, 2] is None
        assert "torchrun --nproc_per_node 4" in errors[2, 2]
        assert "torchrun --nproc_per_node 3" in errors[1, 3]


def test_model_axis_checkpoint_loads_on_other_meshes(runs):
    """Rank 0 writes the 1 x 2 step's state whole: one process restores it
    (the parameters and Adam's moments equal one process's own step within
    Adam's bound and 1e-5), and both ranks restore it exactly, sharded
    again on 1 x 2 and unsharded (2 x 1)."""
    for r in runs["ranks"]["tp"]:
        assert r["restore"] == {"sharded": True, "unsharded": True}
    cfg = mesh_config()
    state = create_train_state(cfg, init_model(cfg), steps_per_epoch=10)
    assert CheckpointManager(runs["tmp"] / "ckpt").restore_state(state)
    assert fingerprint(state.model.state_dict()) == runs["ranks"]["tp"][0]["tp"]["fingerprint"]
    assert state.step == 1


@pytest.mark.parametrize("name", list(TP_FORWARDS))
def test_sharded_forward_on_model_axis_matches_jax(runs, name):
    """`make_sharded_forward` on `create_mesh(1, 2)` (a data axis of one):
    a plain model at batch 1 and 2, a `shard_model` model through its
    plan, and that model with `spatial=True`. Each rank runs the data
    group's whole batch (the ranks of a model group run the same images)
    and returns JAX `make_sharded_forward`'s four maps on its 2-device
    mesh (on `shard_variables` where sharded) within atol 1e-5, and the
    port's one-process forward's."""
    inputs = TP_FORWARDS[name][0]
    batch = TP_FORWARD_INPUTS[inputs][0][0]
    for r in runs["ranks"]["tp"]:
        got = r["forward"][name]
        assert isinstance(got, dict), got
        assert got["batch_seen"] == [batch]
        for key, value in runs["jax"][f"forward_{name}"].items():
            np.testing.assert_allclose(got["maps"][key].numpy(), value, atol=1e-5, err_msg=key)
        for key, value in runs["one"][f"forward_{inputs}"].items():
            assert float((got["maps"][key] - value).abs().max()) <= 1e-5, key


def test_sharded_model_without_its_plan_raises(runs):
    """A model whose convs hold Cout shards, run through `make_sharded_forward`
    without `partition=`, raises a ValueError that names `partition=`
    (not cuDNN's channel-count error)."""
    for r in runs["ranks"]["tp"]:
        kind, message = r["forward"]["missing_plan"]
        assert kind == "ValueError" and "partition=" in message, message


@pytest.mark.parametrize("name", list(ROW_INPUTS))
def test_row_forward_matches_jax_make_forward(runs, name):
    """`make_sharded_forward(spatial=True)` over 1 x 4 rows on JAX's shapes
    (32x32 at batch 4: layer3 and layer4 have fewer rows than ranks; 64x64
    at batch 1, JAX's giant-image case over 4 ranks where JAX uses 8):
    every rank returns JAX `make_forward`'s four maps within 1e-5, and the
    port's one-process forward's."""
    for r in runs["ranks"]["rows"]:
        for key, value in runs["jax"][name].items():
            np.testing.assert_allclose(r[name][key].numpy(), value, atol=1e-5, err_msg=key)
        for key, value in runs["one"][name].items():
            assert float((r[name][key] - value).abs().max()) <= 1e-5, key


@pytest.mark.parametrize("name", list(ROW_VARIANTS))
def test_row_forward_variants_match_one_process(runs, name):
    """The space-to-depth stem (its 4x4 conv reads pairs of rows) and
    `--head_conv` (a 3x3 conv after the FPN) through the row forward:
    every rank returns the one-process forward within 1e-5."""
    want = runs["one"][name]
    for r in runs["ranks"]["rows"]:
        for key, value in want.items():
            assert float((r[name][key] - value).abs().max()) <= 1e-5, key


def test_spatial_step_matches_jax_single_device(runs):
    """The 2 x 2 spatial step (batch over data, rows over model) from JAX's
    weights: the ranks agree; against JAX's single-device step the loss
    within 1e-5 and the head bias within 1e-6 (JAX
    test_spatial_train_step_matches); against one process the gradient
    and state within the 2 x 2 bars."""
    parts = runs["ranks"]["rows"]
    assert len({p["spatial"]["fingerprint"]["head.conv.bias"] for p in parts}) == 1
    assert len({json.dumps(p["spatial"]["fingerprint"], sort_keys=True) for p in parts}) == 1
    got = parts[0]["spatial"]
    loss, bias = runs["jax"]["single"]
    assert got["loss"] == pytest.approx(loss, rel=1e-5)
    np.testing.assert_allclose(got["state"]["head.conv.bias"].numpy(), bias, atol=1e-6)
    _held_to(got, runs["one"]["jax_weights"], runs["one"]["jax_weights_f64"])


@pytest.mark.parametrize("fault", list(FAULTS))
def test_spatial_bar_refuses_planted_fault(runs, fault):
    """The spatial step's gradient bar separates a wrong backward from
    float32's rounding: with the halo gradients dropped, or the gathered
    head output's gradient summed over the rows' ranks, the first step's
    gradient lands outside it."""
    one, f64 = runs["one"]["jax_weights"], runs["one"]["jax_weights_f64"]
    assert _grad_gap(runs["ranks"]["rows"][0][fault], f64["grad"]) > _grad_bar(one, f64)


def test_tensor_parallel_step_over_data_and_model(runs):
    """2 x 2: the model axis with DDP over the data group; every rank holds
    the same whole state, within the 2 x 2 bars of one process."""
    parts = runs["ranks"]["rows"]
    assert len({json.dumps(p["tp_2x2"]["fingerprint"], sort_keys=True) for p in parts}) == 1
    _held_to(parts[0]["tp_2x2"], runs["one"]["seeded"], runs["one"]["seeded_f64"])


# -- cli.train --model_parallel 2 -------------------------------------------


def _cli_data(tmp_path):
    """8 training and 3 validation PNGs with annotations; `cli.train`'s and
    `cli.evaluate`'s common arguments."""
    data = tmp_path / "data"
    _write_images(data / "train", [(80, 64), (100, 90), (64, 64), (70, 120)] * 2, seed=41,
                  annotated=True)
    _write_images(data / "valid", [(90, 70), (64, 80), (110, 100)], seed=42, annotated=True)
    (data / "labels.json").write_text(json.dumps({"labels": ["bean", "maize"],
                                                  "parts": ["leaf"]}))
    common = ["--labels", str(data / "labels.json"), "--anchor_name", "stem",
              "--width", "32", "--height", "32", "--fpn_depth", "8", "--max_objects", "4",
              "--max_parts", "8", "--no_amp", "--num_workers", "0", "--eval_batch_size", "3"]
    return data, common


def _cli_ranks(tmp_path, case, data, common, *extra):
    """`cli.train --model_parallel 2 --device cpu`, 1 epoch, on 2 ranks, each
    in a working directory of its own: (the ranks' results, the
    directories)."""
    argv = ["--device", "cpu", "--model_parallel", "2", "--train_dir", str(data / "train"),
            "--valid_dir", str(data / "valid"), "--epochs", "1", "--batch_size", "4", *extra,
            *common]
    cwd = [tmp_path / f"cwd{r}" for r in (0, 1)]
    for d in cwd:
        d.mkdir()
    return start_ranks(tmp_path / "ranks", case, *argv, rank_args=lambda r: [cwd[r]])(), cwd


def test_cli_train_model_parallel(tmp_path):
    """`cli.train --model_parallel 2 --device cpu` under 2 ranks, 1 epoch,
    each rank in a working directory of its own: the ranks hold the same
    whole state, rank 0 alone writes `trainings/`, and its files hold
    whole tensors: the state restores in one process, the snapshot loads
    in JAX `load_params` and in a one-process port `cli.evaluate`."""
    data, common = _cli_data(tmp_path)
    parts, cwd = _cli_ranks(tmp_path, "cli", data, common)
    assert [p["steps"] for p in parts] == [2, 2] and [p["batches"] for p in parts] == [2, 2]
    assert parts[0]["fingerprint"] == parts[1]["fingerprint"]
    assert not list(cwd[1].iterdir()), "rank 1 wrote files"
    run = cwd[0] / parts[0]["save_dir"]
    cfg = small_config(fpn_depth=8, max_objects=4, max_parts=8)
    state = create_train_state(cfg, init_model(cfg), steps_per_epoch=2)
    assert CheckpointManager(run).restore_state(state) and state.step == 2
    assert fingerprint(state.model.state_dict()) == parts[0]["fingerprint"]
    ckpt = run / "model_best_loss.msgpack"
    tree = load_params(str(ckpt))
    assert tree["params"]["up1"]["kernel"].shape == (1, 1, 512, 8)
    assert tree["params"]["head"]["kernel"].shape == (1, 1, 8, 7)
    assert evaluate_cli.main(["--device", "cpu", "--valid_dir", str(data / "valid"),
                              "--load_model", str(ckpt), *common])
    shutil.rmtree(run)


def test_cli_train_model_parallel_host_augment(tmp_path):
    """`--host_augment --model_parallel 2`: each rank computes its channels
    of one batch, so the model group trains on its first rank's host
    draws even where the ranks' draws differ (here their augmentation
    rngs are seeded by rank, as the loader threads' order may leave
    them): every step takes the same batch on both ranks."""
    data, common = _cli_data(tmp_path)
    parts, cwd = _cli_ranks(tmp_path, "host_augment", data, common, "--host_augment")
    shutil.rmtree(cwd[0] / "trainings")
    assert [len(p["batch_digests"]) for p in parts] == [2, 2]
    assert parts[0]["batch_digests"] == parts[1]["batch_digests"]
    assert parts[0]["fingerprint"] == parts[1]["fingerprint"]
