"""The port's train and eval steps against JAX `make_train_step` /
`make_eval_step`, on the CPU.

64x64 input, batch 8, `fpn_depth` 16, fp32, two labels and one part
kind, the MSE heatmap loss (the default), no augmentation; the JAX step
is built with `donate=False` and compiled once for the module. Smaller
batches and inputs leave the last stages' BN layers a handful of values
a channel: at 32x32 and batch 2 the train-mode forwards part by 1 %
(flax's one-pass variance E[x^2] - E[x]^2 loses most of its digits), and
at 32x32 batch 8 a float32 gradient of either package departs from a
float64 evaluation by 1-20 % in the third stage. Here the forwards agree
to 2e-5. The same `init_model` weights (BN statistics perturbed)
reach the port through `state_dict_from_jax`, and the same batch goes
through both, 5 steps:

- BN running mean and variance after step 1 within 1e-5 of flax's:
  flax writes the biased batch variance, `torch.nn.BatchNorm2d` the
  unbiased one (the port's `BatchNorm2d` corrects it);
- the step-1 gradients against `jax.grad` of the same loss (inside the
  JAX step; read back from Adam's first moment, (1 - b1) * grad after
  one step) and against a float64 evaluation of the loss through the
  port. The FPN's and the head's agree element by element within 1e-4
  of each tensor's largest magnitude. In the encoder neither float32
  gradient holds element by element: measured at this size, the JAX
  step's departs from the float64 one by up to 17 % of a tensor's
  largest magnitude and 1.9 % in relative L2 norm, the port's by up to
  3 % and 0.64 % (ReLU and max-pool decisions that rounding flips, and
  flax differentiating its one-pass variance). So each encoder tensor is
  held in relative L2 norm: within 3e-2 of the JAX gradient, within 1e-2
  of the float64 one and no farther from it than the JAX gradient is
  (or 1e-4); the whole gradient within 1e-2 of the JAX one;
- the loss of each of the 5 steps within 1e-3 relative;
- the parameters after 5 steps within 2 * lr * steps: Adam's first
  update moves each parameter by about lr * sign(grad), so a gradient
  element near 0 may take either sign on rounding alone (the BN
  statistics are held at step 1: later they follow the parameters);
- `eval_step`'s stats and GT heatmaps against `make_eval_step`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structuredetector_tpu.models import init_model as jax_init_model
from structuredetector_tpu.train.state import create_train_state as jax_create_train_state
from structuredetector_tpu.train.state import make_optimizer as jax_make_optimizer
from structuredetector_tpu.train.steps import make_eval_step, make_train_step
from structuredetector_tpu_torch.models.network import build_model
from structuredetector_tpu_torch.models.weights import state_dict_from_jax
from structuredetector_tpu_torch.train.state import create_train_state
from structuredetector_tpu_torch.ops.decode import split_head_output
from structuredetector_tpu_torch.ops.losses import sdnet_loss
from structuredetector_tpu_torch.train.steps import encode_batch, eval_step, train_step
from tests.test_torch_port_model import nontrivial_variables, port_config

STEPS, LR, SIZE, GRID = 5, 1e-3, 64, 16

@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads for this module's CPU training runs: the suite
    runs in several worker processes at once, and a worker per core each
    asking for every core slows every worker several times over."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)



@pytest.fixture(scope="module")
def jax_cfg(tiny_config):
    return dataclasses.replace(tiny_config, width=SIZE, height=SIZE, fpn_depth=16,
                               max_objects=3, max_parts=5, learning_rate=LR, epochs=9,
                               lr_step=3, use_amp=False, hm_loss_fn="mse")


def _batch(cfg, b=8, seed=0):
    """Images and padded keypoints of one batch, from a numpy seed."""
    rng = np.random.default_rng(seed)
    o, p = cfg.max_objects, cfg.max_parts
    kp = {
        "anchors_xy": rng.uniform(0.5, GRID - 0.5, (b, o, 2)).astype(np.float32),
        "anchor_cls": rng.integers(0, 2, (b, o)).astype(np.int32),
        "anchor_mask": rng.random((b, o)) < 0.6,
        "parts_xy": rng.uniform(0.5, GRID - 0.5, (b, p, 2)).astype(np.float32),
        "part_kind": np.zeros((b, p), np.int32),
        "part_owner_xy": rng.uniform(0.5, GRID - 0.5, (b, p, 2)).astype(np.float32),
        "part_mask": rng.random((b, p)) < 0.8,
    }
    images = rng.normal(0, 1, (b, cfg.height, cfg.width, 3)).astype(np.float32)
    return images, kp


@pytest.fixture(scope="module")
def runs(jax_cfg):
    """Both packages' 5-step runs from the same weights on the same batch."""
    variables = nontrivial_variables(jax_cfg, seed=11)
    images, kp = _batch(jax_cfg)

    model, _ = jax_init_model(jax_cfg)
    opt = jax_make_optimizer(jax_cfg, steps_per_epoch=1000)
    state = jax_create_train_state(jax_cfg, jax.tree.map(jnp.asarray, variables), opt)
    step = make_train_step(model, jax_cfg, opt, out_h=GRID, out_w=GRID, donate=False)
    jkp = {k: jnp.asarray(v) for k, v in kp.items()}
    jax_states, jax_losses = [], []
    for _ in range(STEPS):
        state, stats = step(state, jnp.asarray(images), jkp)
        jax_states.append(jax.tree.map(np.asarray, state))
        jax_losses.append(float(stats["total_loss"]))
    eval_want = make_eval_step(model, jax_cfg, out_h=GRID, out_w=GRID)(
        jax.tree.map(jnp.asarray, variables), jnp.asarray(images), jkp)

    cfg = port_config(jax_cfg)
    net = build_model(cfg, dtype=torch.float32)
    net.load_state_dict(state_dict_from_jax(variables), strict=True)
    tstate = create_train_state(cfg, net, steps_per_epoch=1000)
    timages = torch.from_numpy(images)
    tkp = {k: torch.from_numpy(v) for k, v in kp.items()}
    eval_got = eval_step(net, timages, tkp, cfg)
    port_losses, port_sds, grads = [], [], None
    for i in range(STEPS):
        stats = train_step(tstate, timages, tkp, cfg)
        port_losses.append(float(stats["total_loss"]))
        port_sds.append({k: v.clone() for k, v in net.state_dict().items()})
        if i == 0:
            grads = {n: p.grad.clone() for n, p in net.named_parameters()}
    # the same loss in float64 through the port (the head output is
    # rounded to float32 once, in the model's last cast)
    ref = build_model(cfg, dtype=torch.float32)
    ref.load_state_dict(state_dict_from_jax(variables), strict=True)
    ref.double().train()
    head = ref(timages.double().permute(0, 3, 1, 2).contiguous(), raw_output=True).double()
    total, _ = sdnet_loss(split_head_output(head, cfg.n_labels, cfg.n_parts),
                          encode_batch({k: v for k, v in tkp.items()}, cfg, GRID, GRID))
    total.backward()
    grads64 = {n: p.grad for n, p in ref.named_parameters()}
    return dict(grads64=grads64, start=state_dict_from_jax(variables), jax_states=jax_states,
                jax_losses=jax_losses, port_losses=port_losses, port_sds=port_sds, grads=grads,
                tstate=tstate, eval_want=eval_want, eval_got=eval_got)


def _as_state_dict(tree_params, batch_stats):
    return state_dict_from_jax({"params": tree_params, "batch_stats": batch_stats})


def test_bn_running_stats_after_one_step_match_flax(runs):
    want = _as_state_dict(runs["jax_states"][0].params, runs["jax_states"][0].batch_stats)
    got = runs["port_sds"][0]
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 39  # 36 encoder BNs + 3 FPN BNs
    for k in keys:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=0, atol=1e-5,
                                   err_msg=k)
    # torch's own update, (1 - m) rv + m var n / (n - 1), is off by the
    # variance's share / (n - 1): at the stem (n = 8 * 32 * 32) beyond 1e-5
    key, n = "adpater.1.running_var", 8 * 32 * 32
    old = runs["start"][key].numpy()
    biased = (want[key].numpy() - 0.9 * old) / 0.1
    unbiased_update = 0.9 * old + 0.1 * biased * n / (n - 1)
    assert np.abs(unbiased_update - want[key].numpy()).max() > 1e-5


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm((a - b).ravel()) / np.linalg.norm(b.ravel()))


def test_step1_gradients_match_jax_grad(runs):
    mu = runs["jax_states"][0].opt_state[0].mu  # (1 - b1) * grad after one step
    want = _as_state_dict(jax.tree.map(lambda m: np.asarray(m) / 0.1, mu),
                          runs["jax_states"][0].batch_stats)
    got, exact = runs["grads"], runs["grads64"]
    assert set(got) <= set(want)
    for k, g in got.items():
        g, w, x = g.numpy(), want[k].numpy(), exact[k].numpy().astype(np.float32)
        scale = float(np.abs(w).max())
        assert scale > 0, k
        if k.startswith(("up", "head")):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * scale, err_msg=k)
            continue
        to_jax, to_exact, jax_to_exact = _rel_l2(g, w), _rel_l2(g, x), _rel_l2(w, x)
        assert to_jax <= 3e-2, (k, to_jax)
        assert to_exact <= min(1e-2, max(jax_to_exact, 1e-4)), (k, to_exact, jax_to_exact)
    flat = {name: np.concatenate([d[k].numpy().ravel() for k in got])
            for name, d in (("port", got), ("jax", want))}
    assert _rel_l2(flat["port"], flat["jax"]) <= 1e-2


def test_loss_trajectory_matches_jax(runs):
    np.testing.assert_allclose(runs["port_losses"], runs["jax_losses"], rtol=1e-3)
    assert runs["port_losses"][-1] < runs["port_losses"][0]
    assert runs["tstate"].step == STEPS


def test_params_after_five_steps_match_jax(runs):
    last = runs["jax_states"][-1]
    want = _as_state_dict(last.params, last.batch_stats)
    got = runs["port_sds"][-1]
    moved = 0
    for k, w in want.items():
        if k.endswith("num_batches_tracked"):
            assert int(got[k]) == STEPS
        if k.endswith(("num_batches_tracked", "running_mean", "running_var")):
            continue  # held at step 1; later they follow the parameters
        # an Adam step moves a parameter by about lr, a rounding-flipped
        # gradient sign by twice that
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=0, atol=2 * LR * STEPS,
                                   err_msg=k)
        moved += int(np.abs(w.numpy() - runs["port_sds"][0][k].numpy()).max() > 0)
    assert moved > 0


def test_eval_step_matches_jax(runs):
    out_w, stats_w, gt_w = runs["eval_want"]
    out_g, stats_g, gt_g = runs["eval_got"]
    for k, v in stats_w.items():
        np.testing.assert_allclose(float(stats_g[k]), float(v), rtol=1e-4, err_msg=k)
    for k in ("anchor_hm", "part_hm"):
        np.testing.assert_allclose(gt_g[k].numpy(), np.transpose(np.asarray(gt_w[k]), (0, 3, 1, 2)),
                                   rtol=0, atol=1e-6)
    for k in ("anchor_hm", "offsets"):
        np.testing.assert_allclose(out_g[k].numpy(),
                                   np.transpose(np.asarray(out_w[k]), (0, 3, 1, 2)),
                                   rtol=1e-3, atol=1e-4, err_msg=k)
