"""The port's profiler spans and its serving queue-wait counter, on the CPU.

``utils/profiling.span`` is a ``record_function`` range while a profiler
session records and one shared do-nothing context otherwise. A tiny
pixel-space DDPM and VQ-VAE show which spans a train step and a sampler
chain record, how they nest, that recording them changes no number, and
that an artifact exported under a recording session holds no profiler op.
``BatchingSampler`` with a stand-in sampler that sleeps shows
``queue_wait_seconds``.
"""

import io
import time
import zipfile
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

from spectrogramgenai_tpu_torch.core import config as tc  # noqa: E402
from spectrogramgenai_tpu_torch.models.layers import GroupNorm, LayerNorm  # noqa: E402
from spectrogramgenai_tpu_torch.serving import BatchingSampler  # noqa: E402
from spectrogramgenai_tpu_torch.serving.export import export_sampler  # noqa: E402
from spectrogramgenai_tpu_torch.train.diffusion_task import DiffusionTask  # noqa: E402
from spectrogramgenai_tpu_torch.train.vqvae_task import VQVAETask  # noqa: E402
from spectrogramgenai_tpu_torch.utils import profiling  # noqa: E402
from torch_port_helpers import one_torch_thread  # noqa: E402, F401

CFG = tc.DDPMConfig(img_size=16, latent=False, num_classes=3, noise_steps=20, width_mult=0.125,
                    remove_deep_conv=True, compute_dtype="float32", ema_start=0)
CHAIN_STEPS = 2
BATCH = 2


def _ddpm():
    task = DiffusionTask(CFG, "cpu", total_steps=10)
    return task, task.init_state(0)


def _batch():
    g = torch.Generator().manual_seed(1)
    return torch.rand((BATCH, 16, 16, 1), generator=g), torch.tensor([0, 2])


def _chain(task):
    return task.sample_latents([0, 1], generator=torch.Generator().manual_seed(2), sampler="dpmpp",
                               num_steps=CHAIN_STEPS)


def _recorded(fn):
    """``fn()``'s result and the ranges named ``sgai.*`` that a CPU profiler recorded meanwhile."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, [e for e in prof.events() if e.name.startswith("sgai.")]


def _inside(outer, events):
    """The events inside ``outer``'s time range on its thread."""
    return [e for e in events if e is not outer and e.thread == outer.thread
            and outer.time_range.start <= e.time_range.start and e.time_range.end <= outer.time_range.end]


def _named(events, name):
    return [e for e in events if e.name == name]


# -- (a) off: one shared null context, and numbers unchanged by recording -----------------------

def test_span_is_the_shared_null_context_without_a_profiler():
    assert profiling.span("sgai.a") is profiling.span("sgai.b") is profiling._OFF
    with profile(activities=[ProfilerActivity.CPU]):
        assert profiling.span("sgai.a") is not profiling._OFF


def test_train_step_and_chain_are_bit_equal_with_and_without_a_profiler():
    x, y = _batch()
    runs = []
    for recording in (False, True):
        task, state = _ddpm()

        def work():
            _, m = task.train_step(state, x, y)
            return m["train_mse"], _chain(task)

        (loss, chain), _ = _recorded(work) if recording else (work(), None)
        runs.append((loss, chain, {k: v.clone() for k, v in state.params.items()},
                     {k: v.clone() for k, v in state.ema_params.items()}))
    (loss0, chain0, p0, e0), (loss1, chain1, p1, e1) = runs
    torch.testing.assert_close(loss1, loss0, rtol=0, atol=0)
    torch.testing.assert_close(chain1, chain0, rtol=0, atol=0)
    for k in p0:
        torch.testing.assert_close(p1[k], p0[k], rtol=0, atol=0)
        torch.testing.assert_close(e1[k], e0[k], rtol=0, atol=0)


# -- (b) a train step's spans ------------------------------------------------------------------

def test_ddpm_step_records_optimizer_and_ema_inside_the_step():
    task, state = _ddpm()
    x, y = _batch()
    _, events = _recorded(lambda: task.train_step(state, x, y))
    (step,) = _named(events, "sgai.train.step")
    inner = _inside(step, events)
    assert len(_named(inner, "sgai.train.optimizer")) == len(_named(events, "sgai.train.optimizer")) == 1
    assert len(_named(inner, "sgai.train.ema")) == len(_named(events, "sgai.train.ema")) == 1
    assert len(_named(inner, "sgai.norm.group")) == sum(isinstance(m, GroupNorm) for m in task.model.modules())


def test_vqvae_step_records_step_and_optimizer_and_no_ema():
    task = VQVAETask(tc.VQVAEConfig(hidden_dim=8, n_embeddings=8, compute_dtype="float32"), "cpu")
    state = task.init_state(0)
    x, _ = _batch()
    _, events = _recorded(lambda: task.train_step(state, x))
    (step,) = _named(events, "sgai.train.step")
    assert [e.name for e in _inside(step, events)] == ["sgai.train.optimizer"]
    assert sorted(e.name for e in events) == ["sgai.train.optimizer", "sgai.train.step"]


# -- (c) a chain's spans -----------------------------------------------------------------------

def test_chain_records_one_chain_span_holding_each_norm_of_every_step():
    task, _ = _ddpm()
    _, events = _recorded(lambda: _chain(task))
    (chain,) = _named(events, "sgai.sample.chain")
    inner = _inside(chain, events)
    groups = sum(isinstance(m, GroupNorm) for m in task.model.modules())
    layers = sum(isinstance(m, LayerNorm) for m in task.model.modules())
    assert groups > 0 and layers > 0
    assert len(_named(inner, "sgai.norm.group")) == len(_named(events, "sgai.norm.group")) == CHAIN_STEPS * groups
    assert len(_named(inner, "sgai.norm.layer")) == len(_named(events, "sgai.norm.layer")) == CHAIN_STEPS * layers


# -- (d) an export under a recording session holds no profiler op --------------------------------

def test_export_under_a_profiler_holds_no_profiler_op():
    task, _ = _ddpm()
    task.model.eval()
    blob, events = _recorded(lambda: export_sampler(task, num_labels=1, sampler="ddim", num_steps=2,
                                                    cfg_scale=0.0))
    assert events == []
    with zipfile.ZipFile(io.BytesIO(blob)) as z:
        programs = [torch.export.load(io.BytesIO(bytearray(z.read(n)))) for n in ("eps_cpu.pt2", "decode_cpu.pt2")]
    targets = [str(nd.target) for p in programs for nd in p.graph.nodes if nd.op == "call_function"]
    assert targets and not [t for t in targets if "profiler" in t]


# -- (e) the serving queue's wait -----------------------------------------------------------------

def test_queue_wait_counts_a_slot_held_behind_a_sleeping_batch():
    delay = 0.25

    def sample(labels, **_):
        time.sleep(delay)
        return torch.zeros((len(labels), 2, 2, 1), dtype=torch.uint8)

    b = BatchingSampler(SimpleNamespace(device=torch.device("cpu"), sample=sample), batch_size=1, max_delay_ms=1.0)
    try:
        b.submit(0, count=2).result(timeout=30)  # two slots at one submit; the second waits out the first's batch
        raw = b.stats["queue_wait_seconds"]
        s = b.snapshot_stats()
    finally:
        b.close()
    assert s["slots_filled"] == 2 and s["batches"] == 2
    assert raw >= delay and s["queue_wait_seconds"] == round(raw, 3) >= delay
