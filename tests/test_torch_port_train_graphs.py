"""The train step's CUDA graphs (`train/graphs.py`) on the CPU.

A CUDA graph needs the card (`tests/test_torch_port_cuda.py` replays
real ones). Here:

- `eager_reason`: which input or set-up keeps the step eager, and that a
  forward hook on the model is no reason;
- the `train_graph` counters, kept apart from the collector's;
- `StepGraphs` driven by a stand-in recorder (`CpuGraphs`): a capture
  runs the body once and puts back everything it changed, as a capture
  that runs nothing leaves the state; a replay runs the body again and
  writes its outputs where the capture's were. Against the eager step
  from the same weights, over two buckets and a schedule boundary: the
  stats, the parameters, the BatchNorm buffers and Adam's state equal
  bit for bit, the forward hooks see each step's head once, what they
  and the caller got stays as it was after later replays, one capture a
  bucket and one more a bucket after the boundary, and a loaded state
  is copied into the tensors the graphs read;
- `TrainState.state_dict()` keeps the eager step's keys and value types
  (the rate a float, `capturable` off) and loads into a fresh state.
"""

import collections
import copy
import io
import types

import numpy as np
import pytest
import torch

from structuredetector_tpu_torch import tracing
from structuredetector_tpu_torch.config import Config
from structuredetector_tpu_torch.models.network import init_model
from structuredetector_tpu_torch.ops.device_augment import (
    draw_augment_params,
    pack_augment_params,
    step_generator,
    unpack_augment_params,
)
from structuredetector_tpu_torch.train import steps
from structuredetector_tpu_torch.train.graphs import ADAM_STATE, StepGraphs, eager_reason
from structuredetector_tpu_torch.train.state import TrainState, make_lr_schedule

B = 4
BUCKETS = {"a": (64, 64), "b": (96, 64)}  # (w, h)
ORDER = ["a", "b", "a", "b", "b", "a"]  # the rate falls at step 3
STEPS_PER_EPOCH = 3


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: the suite runs in several worker processes."""
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _config():
    # epochs 2, lr_step 2: the rate falls /10 after one epoch
    return Config(width=64, height=64, fpn_depth=32, use_amp=False, epochs=2,
                  lr_step=2).set_labels(["bean", "maize"], ["leaf"])


def _state(cfg, model):
    """A state with fused Adam, as the card's (`state.make_optimizer`)."""
    schedule = make_lr_schedule(cfg, STEPS_PER_EPOCH)
    opt = torch.optim.Adam(model.parameters(), lr=schedule(0), betas=(0.9, 0.999), eps=1e-8,
                           weight_decay=0.0, fused=True)
    return TrainState(model, opt, schedule)


def _batch(cfg, bucket, seed):
    """uint8 images of the bucket's size and padded keypoints on its grid."""
    w, h = BUCKETS[bucket]
    gw, gh = w // cfg.down_ratio, h // cfg.down_ratio
    rng = np.random.default_rng(seed)
    o, p = cfg.max_objects, cfg.max_parts

    def xy(n):
        return np.stack([rng.uniform(0.5, gw - 0.5, (B, n)),
                         rng.uniform(0.5, gh - 0.5, (B, n))], -1).astype(np.float32)

    kp = {"anchors_xy": xy(o), "anchor_cls": rng.integers(0, 2, (B, o)).astype(np.int32),
          "anchor_mask": rng.random((B, o)) < 0.6, "parts_xy": xy(p),
          "part_kind": np.zeros((B, p), np.int32), "part_owner_xy": xy(p),
          "part_mask": rng.random((B, p)) < 0.8}
    images = rng.integers(0, 256, (B, h, w, 3), dtype=np.uint8)
    return torch.from_numpy(images), {k: torch.from_numpy(v) for k, v in kp.items()}


def _touched(state):
    """Every tensor the step writes: parameters, buffers, gradients, Adam."""
    model, opt = state.model, state.optimizer
    out = list(model.parameters()) + list(model.buffers())
    out += [p.grad for p in model.parameters() if p.grad is not None]
    for p in model.parameters():
        out += [opt.state[p][k] for k in ADAM_STATE if k in opt.state[p]]
    return out


class _Replay:
    """Runs the body again as a replay would: no Python hook fires."""

    def __init__(self, fn, outputs, model):
        self.fn, self.outputs, self.model = fn, outputs, model

    def replay(self):
        hooks, self.model._forward_hooks = self.model._forward_hooks, collections.OrderedDict()
        try:
            x, head, stats = self.fn()
        finally:
            self.model._forward_hooks = hooks
        ox, ohead, ostats = self.outputs
        ox.copy_(x)
        ohead.copy_(head)
        for name, value in stats.items():
            ostats[name].copy_(value)


class CpuGraphs(StepGraphs):
    """`StepGraphs` with a recorder that runs on the CPU (see the module's
    docstring); the draws go straight into the draw tensor."""

    def __init__(self, state):
        super().__init__()
        self._state = state

    def _record(self, device, fn):
        with torch.no_grad():
            saved = [t.clone() for t in _touched(self._state)]
        outputs = fn()
        with torch.no_grad():
            for t, s in zip(_touched(self._state), saved):
                t.copy_(s)
        return _Replay(fn, outputs, self._state.model), outputs, 0

    def _put_draws(self, feed, draws):
        pack_augment_params(draws, feed.draws)


def _graphed(state):
    state.graphs = CpuGraphs(state)
    return state


def _graph_step(state, images, kp, cfg):
    """`train_step`'s replay branch, reached on the CPU."""
    graphs = state.graphs
    key = graphs.key(images, kp, True, cfg)
    if not graphs.warmed(key):
        graphs.warm(key, images, kp, [True] * len(list(state.model.parameters())))
    return graphs.step(key, state, images, kp, cfg, True, steps._graph_body)


def _eager_step(state, images, kp, cfg):
    return steps.train_step(state, images, kp, cfg, augment=True)


def _equal_states(a, b):
    for (name, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), name
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        for k in ADAM_STATE:
            assert torch.equal(a.optimizer.state[p][k], b.optimizer.state[q][k]), k
    assert a.step == b.step


def _watch(model):
    seen = []
    model.register_forward_hook(lambda m, args, out: seen.append(out))
    return seen


# ------------------------------------------------------------- eager or graph

def _cuda_like(images):
    """An input that says it is on a CUDA device (`eager_reason` reads its
    device only)."""
    return types.SimpleNamespace(device=torch.device("cuda"))


def _noop(*args):
    return None


# case -> the reason `eager_reason` gives
REASONS = {"cpu": "cpu", "forward_hook_watches": "cpu", "pre_hook": "pre_hooks",
           "inner_hook": "module_hooks", "backward_hook": "module_hooks",
           "global_hook": "module_hooks", "debug_nans": "debug_nans", "sharded": "sharded",
           "spatial": "spatial", "process_group": "process_group",
           "unfused_on_card": "unfused_optimizer", "fused_on_card": None,
           "fused_on_card_watched": None}


def _arrange(case, state, cfg, images):
    """Set `case` up on the state; returns eager_reason's arguments and the
    handles to remove after."""
    model, kw, handles = state.model, {}, []
    if case in ("forward_hook_watches", "fused_on_card_watched"):
        handles.append(model.register_forward_hook(_noop))
    if case == "pre_hook":
        handles.append(model.register_forward_pre_hook(_noop))
    if case == "inner_hook":
        handles.append(model.head.conv.register_forward_hook(_noop))
    if case == "backward_hook":
        handles.append(model.register_full_backward_hook(_noop))
    if case == "global_hook":
        handles.append(torch.nn.modules.module.register_module_forward_hook(_noop))
    if case == "debug_nans":
        cfg.debug_nans = True
    if case == "sharded":
        state.partition = object()
    if case == "spatial":
        kw["spatial"] = True
    if case == "process_group":
        kw["mesh"] = types.SimpleNamespace(size=2)
    if case.endswith(("on_card", "on_card_watched")):
        images = _cuda_like(images)
    if case.startswith("fused"):
        state.optimizer.param_groups[0]["fused"] = True
    return images, kw, handles


@pytest.mark.parametrize("case", sorted(REASONS))
def test_eager_reason(case):
    """The step stays eager only for what its input or set-up shows; a
    forward hook that watches the model keeps the graph."""
    cfg = _config()
    model = init_model(cfg)
    state = TrainState(model, torch.optim.Adam(model.parameters()), lambda step: 1e-3)
    images = torch.zeros((B, 64, 64, 3), dtype=torch.uint8)
    images, kw, handles = _arrange(case, state, cfg, images)
    try:
        assert eager_reason(state, images, cfg, **kw) == REASONS[case]
    finally:
        for handle in handles:
            handle.remove()


def test_anomaly_mode_keeps_the_step_eager():
    cfg = _config()
    model = init_model(cfg)
    state = TrainState(model, torch.optim.Adam(model.parameters(), fused=True), lambda s: 1e-3)
    with torch.autograd.set_detect_anomaly(True):
        assert eager_reason(state, _cuda_like(None), cfg) == "debug_nans"
    assert eager_reason(state, _cuda_like(None), cfg) is None


def test_eager_steps_are_counted_by_reason():
    """Each eager step counts under its reason; the collector's counters
    (`/healthz`'s "gc") keep their three generations only."""
    cfg = _config()
    state = _state(cfg, init_model(cfg))
    images, kp = _batch(cfg, "a", 0)
    before = tracing.train_graph_counters()
    steps.train_step(state, images, kp, cfg, augment=True)
    handle = state.model.register_forward_pre_hook(lambda *a: None)
    steps.train_step(state, images, kp, cfg, augment=True)
    handle.remove()
    after = tracing.train_graph_counters()
    assert set(after) == {"captures", "replays", "eager", "pool_bytes"}
    assert after["eager"].get("cpu", 0) - before["eager"].get("cpu", 0) == 1
    assert after["eager"].get("pre_hooks", 0) - before["eager"].get("pre_hooks", 0) == 1
    assert (after["captures"], after["replays"]) == (before["captures"], before["replays"])
    assert set(tracing.counters()) == {"gen0", "gen1", "gen2"}


def test_augment_draws_pack_into_one_tensor():
    """The draws travel as one float32 (6, B) tensor and come back equal."""
    draws = draw_augment_params(B, step_generator(7, 3), device="cpu")
    packed = pack_augment_params(draws, torch.empty((6, B)))
    for got, want in zip(unpack_augment_params(packed), draws):
        assert got.dtype == want.dtype and torch.equal(got, want)


# ------------------------------------------------------------ graphed steps

@pytest.fixture(scope="module")
def runs():
    """Six steps over ORDER from the same weights, eager and graphed, with
    each step's stats and the head its forward hook saw; the graphed ones
    with the clones taken as they came."""
    cfg = _config()
    model = init_model(cfg)
    eager, graphed = _state(cfg, copy.deepcopy(model)), _graphed(_state(cfg, model))
    seen_eager, seen_graph = _watch(eager.model), _watch(graphed.model)
    before = tracing.train_graph_counters()
    out = {"eager": [], "graph": [], "graph_then": [], "heads_then": []}
    for i, bucket in enumerate(ORDER):
        images, kp = _batch(cfg, bucket, i)
        out["eager"].append(_eager_step(eager, images, kp, cfg))
        stats = _graph_step(graphed, images, kp, cfg)
        out["graph"].append(stats)
        out["graph_then"].append({k: v.clone() for k, v in stats.items()})
        out["heads_then"].append(seen_graph[-1].clone())
    after = tracing.train_graph_counters()
    out.update(eager_state=eager, graph_state=graphed, seen_eager=seen_eager,
               seen_graph=seen_graph, cfg=cfg,
               counts={k: after[k] - before[k] for k in ("captures", "replays")})
    return out


def test_graphed_steps_equal_eager_steps(runs):
    for want, got in zip(runs["eager"], runs["graph"]):
        assert set(got) == set(want)
        for name in want:
            assert torch.equal(got[name], want[name]), name
    _equal_states(runs["graph_state"], runs["eager_state"])


def test_forward_hooks_see_each_replay_once(runs):
    assert len(runs["seen_graph"]) == len(runs["seen_eager"]) == len(ORDER)
    for got, want in zip(runs["seen_graph"], runs["seen_eager"]):
        assert torch.equal(got, want.detach())


def test_what_a_step_handed_back_outlives_later_replays(runs):
    for stats, then in zip(runs["graph"], runs["graph_then"]):
        for name in stats:
            assert torch.equal(stats[name], then[name])
    for head, then in zip(runs["seen_graph"], runs["heads_then"]):
        assert torch.equal(head, then)


def test_one_capture_a_bucket_and_one_more_after_the_boundary(runs):
    """a and b once each, then b at step 3 and a at step 5 at the new rate."""
    assert runs["counts"] == {"captures": 4, "replays": len(ORDER)}
    graphs = runs["graph_state"].graphs
    schedule = runs["graph_state"].lr_schedule
    assert schedule(2) != schedule(3)
    assert {b.lr for b in graphs._buckets.values()} == {schedule(3)}


def test_a_loaded_state_is_copied_into_the_graphs_tensors():
    """A state loaded into a graphed state (a resume) takes effect at the
    next replay: two more steps from it equal the eager state's."""
    cfg = _config()
    model = init_model(cfg)
    eager, graphed = _state(cfg, copy.deepcopy(model)), _graphed(_state(cfg, model))
    for i, bucket in enumerate(["a", "b"]):
        images, kp = _batch(cfg, bucket, i)
        _eager_step(eager, images, kp, cfg)
        _graph_step(graphed, images, kp, cfg)
    saved = copy.deepcopy(eager.state_dict())
    for i, bucket in enumerate(["a", "a"]):  # the eager state moves on, then back
        _eager_step(eager, *_batch(cfg, bucket, 10 + i), cfg)
        _graph_step(graphed, *_batch(cfg, bucket, 20 + i), cfg)
    eager.load_state_dict(copy.deepcopy(saved))
    graphed.load_state_dict(copy.deepcopy(saved))
    _equal_states(graphed, eager)
    for i, bucket in enumerate(["b", "a"]):
        images, kp = _batch(cfg, bucket, 30 + i)
        want = _eager_step(eager, images, kp, cfg)
        got = _graph_step(graphed, images, kp, cfg)
        for name in want:
            assert torch.equal(got[name], want[name]), name
    _equal_states(graphed, eager)


def test_a_hook_that_replaces_the_output_raises():
    cfg = _config()
    state = _graphed(_state(cfg, init_model(cfg)))
    images, kp = _batch(cfg, "a", 0)
    _graph_step(state, images, kp, cfg)
    state.model.register_forward_hook(lambda m, args, out: out * 2)
    with pytest.raises(RuntimeError, match="replacement output"):
        _graph_step(state, images, kp, cfg)


# ------------------------------------------------------------ checkpoint layout

def _layout(value):
    """Keys, types, dtypes and shapes of a state_dict, values aside."""
    if isinstance(value, dict):
        return {k: _layout(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value), [_layout(v) for v in value]
    if isinstance(value, torch.Tensor):
        return torch.Tensor, value.dtype, tuple(value.shape)
    return type(value)


@pytest.mark.parametrize("path", ["eager", "graph"])
def test_state_dict_keeps_the_eager_layout(runs, path):
    """The checkpoint of a graphed state has the eager state's keys and
    value types: the rate a float, `capturable` off, Adam's step a 0-d
    float32 tensor; it loads into a fresh eager state."""
    state = runs[f"{path}_state"]
    sd = state.state_dict()
    assert _layout(sd) == _layout(runs["eager_state"].state_dict())
    assert set(sd) == {"step", "model", "optimizer"} and type(sd["step"]) is int
    group = sd["optimizer"]["param_groups"][0]
    assert type(group["lr"]) is float and group["lr"] == state.lr_schedule(state.step - 1)
    assert group["capturable"] is False
    for entry in sd["optimizer"]["state"].values():
        assert set(entry) == set(ADAM_STATE)
        assert entry["step"].dtype == torch.float32 and entry["step"].dim() == 0
    buf = io.BytesIO()
    torch.save(sd, buf)
    buf.seek(0)
    cfg = runs["cfg"]
    fresh = _state(cfg, init_model(cfg))
    fresh.load_state_dict(torch.load(buf, weights_only=False))
    _equal_states(fresh, state)
