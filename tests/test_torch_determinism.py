"""The port's determinism policy on the CPU (tpuvc_torch.ops.precision):
the conv-workspace budget that fixes cuDNN's plans whatever else holds the
card, the entry points that refuse to start without it, and training runs
that give the same bits twice under ``deterministic_training``.

The card's side (the budget's plans under a ballast process, two training
runs of every family through the kernels' backward) is in
tests/test_torch_cuda.py and chip_smoke.py."""

import os

import pytest
import torch

from tpuvc_torch.ops import precision

torch.set_num_threads(1)

GIB = 2**30


@pytest.fixture
def card(monkeypatch):
    """A stand-in CUDA card with ``card.free`` bytes free: the checks that
    ``pin_conv_workspace`` makes, and the allocator settings and
    out-of-memory observers it sets (recorded, not applied)."""
    class Card:
        free = 80 * GIB
        observers = []
        settings = []

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "mem_get_info", lambda device=None: (Card.free, 80 * GIB))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device=None: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: 0)
    monkeypatch.setattr(torch._C, "_cuda_attach_out_of_memory_observer",
                        Card.observers.append, raising=False)
    monkeypatch.setattr(precision, "_allocator_settings", Card.settings.append)
    monkeypatch.setattr(precision._PLANS, "observed", False)
    flags = (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    yield Card
    (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
     torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) = flags


def _flags():
    return (torch.backends.cudnn.benchmark, torch.backends.cudnn.deterministic,
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)


def test_set_deterministic_applies_the_budget_once(card):
    """Fixed, deterministic cuDNN heuristics, TF32 off, no cached block
    split at the budget's size or above, one observer that refuses fallback
    plans; a second call changes nothing."""
    precision.set_deterministic("cuda")
    assert _flags() == (False, True, False, False)
    mib = int(precision.CONV_WORKSPACE_GIB * 1024)
    assert card.settings == [f"max_split_size_mb:{mib}"]
    assert card.observers == [precision._refuse_other_plans]
    precision.set_deterministic("cuda")
    assert _flags() == (False, True, False, False)
    assert card.settings == [f"max_split_size_mb:{mib}"]
    assert card.observers == [precision._refuse_other_plans]


def test_budget_is_at_most_the_spatial_cap():
    """The spatial phase's processes run capped at 10 GiB each: the budget
    must fit inside that cap."""
    import chip_smoke

    assert 0 < precision.CONV_WORKSPACE_GIB <= chip_smoke.SPATIAL_MEM_GIB


def test_set_deterministic_on_the_cpu_checks_no_card(monkeypatch):
    """A CPU device asks no card for memory and attaches no observer."""
    monkeypatch.setattr(precision._PLANS, "observed", False)

    def no_card(*a, **k):
        raise AssertionError("asked the card")

    monkeypatch.setattr(torch.cuda, "mem_get_info", no_card)
    precision.set_deterministic("cpu")
    assert _flags()[:2] == (False, True)
    assert precision._PLANS.observed is False


def test_memory_this_process_holds_cached_counts(card, monkeypatch):
    """Free memory plus what the process's allocator holds cached is what
    it can give a workspace."""
    card.free = 1 * GIB
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: int(precision.CONV_WORKSPACE_GIB * GIB))
    precision.set_deterministic("cuda")
    assert len(card.observers) == 1


def test_the_observer_passes_over_only_plans_above_a_window():
    """Inside a plan-fixing window an allocation above its threshold (a
    workspace beyond the budget) fails quietly, so cuDNN takes the next
    plan; any other failed allocation raises, naming the allocation and the
    budget."""
    plans = precision._PLANS
    assert plans.threshold is None
    with pytest.raises(precision.ConvWorkspaceError,
                       match=f"1.50 GiB .*plus {precision.CONV_WORKSPACE_GIB} GiB"):
        precision._refuse_other_plans(0, int(1.5 * GIB), 70 * GIB, GIB // 2)
    plans.threshold = 6 * GIB
    try:
        assert precision._refuse_other_plans(0, 20 * GIB, 70 * GIB, GIB) is None
        with pytest.raises(precision.ConvWorkspaceError):
            precision._refuse_other_plans(0, 5 * GIB, 70 * GIB, GIB)
    finally:
        plans.threshold = None


CONVS = [  # (x NCHW, weight, stride, padding, output_padding)
    ((2, 5, 17, 23), (7, 5, 3, 3), 1, 1, None),
    ((1, 4, 16, 16), (6, 4, 5, 5), 2, 2, None),
    ((2, 3, 9, 11), (8, 3, 1, 1), 2, 0, None),
    ((2, 6, 8, 10), (6, 4, 5, 5), 2, 2, 1),
    ((1, 5, 7, 9), (5, 3, 3, 3), 2, 1, 1),
]


@pytest.mark.parametrize("xs, ws, stride, pad, out_pad", CONVS)
def test_conv_is_the_plain_conv_on_the_cpu(xs, ws, stride, pad, out_pad):
    """On the CPU ``precision.conv`` is F.conv2d (F.conv_transpose2d with
    output_padding) bit for bit, and the window's output shape matches."""
    import torch.nn.functional as F

    g = torch.Generator().manual_seed(0)
    x, w, b = torch.randn(xs, generator=g), torch.randn(ws, generator=g), torch.randn(
        ws[1] if out_pad is not None else ws[0], generator=g)
    if out_pad is None:
        ref = F.conv2d(x, w, b, stride=stride, padding=pad)
    else:
        ref = F.conv_transpose2d(x, w, b, stride=stride, padding=pad, output_padding=out_pad)
    got = precision.conv(x, w, b, stride=stride, padding=pad, output_padding=out_pad)
    assert torch.equal(got, ref)
    assert precision._conv_out_shape(x, w, out_pad is not None, stride, pad,
                                     out_pad or 0) == tuple(ref.shape)


def test_a_plan_is_fixed_in_one_window(monkeypatch):
    """A thread's first call of a conv shape runs with the cache's unused
    segments handed back, blocks of its own allocations' sizes set aside,
    the process capped at what it then holds + the budget and the
    observer's threshold (the budget: the output and the copies take those
    blocks before the workspace is asked for) set; then the process's own
    cap comes back.
    The thread's later calls open no window; another thread's first call
    (PyTorch's plan cache is per thread) opens its own."""
    import threading

    calls = []
    monkeypatch.setattr(precision, "_PLANS", precision._Plans())
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: calls.append("empty"))
    monkeypatch.setattr(torch, "empty", lambda n, **kw: calls.append(("stage", n, kw)))
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda index=None: 10 * GIB)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: type("P", (), {"total_memory": 80 * GIB}))
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, index=None: calls.append(("cap", round(f * 80 * GIB))))
    precision._PLANS.fraction[0] = 0.5

    def run():
        calls.append(("run", precision._PLANS.threshold))
        return "y"

    budget = int(precision.CONV_WORKSPACE_GIB * GIB)
    window = ["empty", ("stage", 7, {"dtype": torch.uint8, "device": "cuda:0"}),
              ("stage", 5, {"dtype": torch.uint8, "device": "cuda:0"}),
              ("cap", 10 * GIB + budget), ("run", budget), ("cap", 40 * GIB)]
    assert precision._fix_plan(run, "key", 0, [7, 5]) == "y"
    assert calls == window
    assert precision._PLANS.threshold is None and "key" in precision._PLANS.seen
    calls.clear()
    assert precision._fix_plan(run, "key", 0, [7, 5]) == "y"
    assert calls == [("run", None)]
    calls.clear()
    other = threading.Thread(target=precision._fix_plan, args=(run, "key", 0, [7, 5]))
    other.start()
    other.join(5)
    assert calls == window


def test_fixing_a_plan_waits_for_running_convs():
    """A conv whose plan is being fixed runs alone: it waits for the convs
    already running, and holds back the ones that start meanwhile."""
    import threading

    plans = precision._Plans()
    events = []
    inside = threading.Event()
    release = threading.Event()

    def reader():
        with plans.shared():
            events.append("reader in")
            inside.set()
            release.wait(5)
            events.append("reader out")

    def writer():
        with plans.exclusive():
            events.append("writer")

    t1 = threading.Thread(target=reader)
    t1.start()
    inside.wait(5)
    t2 = threading.Thread(target=writer)
    t2.start()
    t2.join(0.2)
    assert events == ["reader in"]
    release.set()
    t1.join(5)
    t2.join(5)
    assert events == ["reader in", "reader out", "writer"]


def _in_thread(fn):
    """``fn`` started on a daemon thread; returns the thread."""
    import threading

    t = threading.Thread(target=fn, daemon=True)
    t.start()
    return t


def test_a_window_waits_for_every_thread_at_device_work():
    """A window waits for a holder (a thread whose pool tasks are still
    running) until it parks at a wait; the holder resumes only after the
    window closed."""
    import threading

    plans = precision._Plans()
    events = []
    holding, release = threading.Event(), threading.Event()

    def holder():
        plans.hold()
        events.append("holder runs")
        holding.set()
        release.wait(5)
        with plans.parked():  # a wait on a pool's future
            events.append("holder parked")
        events.append("holder resumed")
        plans.release(threading.current_thread())

    def window():
        with plans.exclusive():
            events.append("window")

    h = _in_thread(holder)
    holding.wait(5)
    w = _in_thread(window)
    w.join(0.3)
    assert events == ["holder runs"]
    release.set()
    w.join(5)
    h.join(5)
    assert events[0] == "holder runs" and events[-1] == "holder resumed"
    assert sorted(events[1:3]) == ["holder parked", "window"]
    assert not plans.holds and not plans.parks and not plans.waiting and not plans.fixing


def test_holders_wait_out_an_open_window():
    """While a window is open, a pool task cannot start and a holder that
    was parked cannot resume; a holder at a conv parks, so the window
    opens, and moves on only once it closed."""
    import threading
    import time

    plans = precision._Plans()
    events, counts = [], []
    opened, close, stop = threading.Event(), threading.Event(), threading.Event()
    state = {"convs": 0}

    def at_convs():  # a holder running convs
        plans.hold()
        while not stop.is_set():
            plans.checkpoint()
            state["convs"] += 1
            time.sleep(0.002)
        plans.release(threading.current_thread())

    def window():
        with plans.exclusive():
            opened.set()
            counts.append(state["convs"])
            close.wait(5)
            counts.append(state["convs"])
            events.append("window closes")

    def task():
        with plans.shared():
            events.append("task")

    def parked_holder():
        plans.hold()
        with plans.parked():
            opened.wait(5)
        events.append("parked holder")
        plans.release(threading.current_thread())

    c = _in_thread(at_convs)
    time.sleep(0.05)
    p = _in_thread(parked_holder)
    w = _in_thread(window)
    assert opened.wait(5)
    t = _in_thread(task)
    t.join(0.2)
    p.join(0.2)
    assert events == []
    close.set()
    for th in (w, t, p):
        th.join(5)
    stop.set()
    c.join(5)
    assert events[0] == "window closes" and sorted(events[1:]) == ["parked holder", "task"]
    assert counts[0] == counts[1] and state["convs"] > counts[1]
    assert not plans.holds and not plans.parks


def test_a_window_does_not_wait_for_a_thread_that_holds_nothing():
    """A thread that ran convs but has no pool task running (a trainer
    blocked in backward while autograd's device thread re-runs a
    checkpointed forward) holds nothing: the other thread's window opens
    at once."""
    import threading

    plans = precision._Plans()
    plans.checkpoint()  # this thread's convs
    opened = threading.Event()

    def window():
        with plans.exclusive():
            opened.set()

    w = _in_thread(window)
    assert opened.wait(2)
    w.join(5)
    assert not plans.holds and not plans.parks and not plans.fixing


def test_pool_tasks_open_windows_while_their_submitter_waits(monkeypatch):
    """A thread waits on pool tasks that each open a window (two at once,
    on two workers): it holds the gate while they run, and waiting on the
    futures and on the pool's shutdown parks it, so no window waits for it
    and none deadlocks; once they finished it holds nothing."""
    import threading

    from tpuvc_torch.coder.parallel import CtxPool

    plans = precision._Plans()
    monkeypatch.setattr(precision, "_PLANS", plans)
    done = []

    def task(k):
        with plans.exclusive():
            done.append(k)
        return k

    pool = CtxPool(max_workers=2)
    try:
        futs = [pool.submit(task, k) for k in range(6)]
        assert [f.result(timeout=10) for f in futs] == list(range(6))
        assert list(pool.map(task, range(6, 9), timeout=10)) == [6, 7, 8]
        pool.shutdown(wait=True)
    finally:  # a deadlocked window would otherwise keep its worker forever
        with plans.cond:
            stuck = dict(plans.holds)
            plans.holds.clear()
            plans.cond.notify_all()
        pool.shutdown(wait=True)
    assert stuck == {}
    assert sorted(done) == list(range(9))
    assert not plans.waiting and not plans.fixing


def test_a_fixed_plan_runs_once_more_after_the_cache_goes_back(monkeypatch):
    """A conv on its fixed plan whose allocation fails hands the cache back
    and runs again; a second failure stands."""
    handed = []
    monkeypatch.setattr(precision, "_hand_back", handed.append)
    tries = []

    def flaky():
        tries.append(1)
        if len(tries) == 1:
            raise precision.ConvWorkspaceError("fragmented")
        return "y"

    assert precision._run_fixed(flaky, 3) == "y"
    assert handed == [3] and len(tries) == 2

    def short():
        raise precision.ConvWorkspaceError("short")

    with pytest.raises(precision.ConvWorkspaceError, match="short"):
        precision._run_fixed(short, 0)
    assert handed == [3, 0]


def test_a_cap_comes_after_the_cache_goes_back(monkeypatch):
    """cap_device_memory collects garbage and empties the cache before it
    caps the process, so what earlier work left cached does not count."""
    calls = []
    monkeypatch.setattr(precision.gc, "collect", lambda: calls.append("gc"))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda index=None: calls.append("sync"))
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: calls.append("empty"))
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: type("P", (), {"total_memory": 80 * GIB}))
    monkeypatch.setattr(torch.cuda, "set_per_process_memory_fraction",
                        lambda f, index=None: calls.append(("cap", f, index)))
    monkeypatch.setattr(precision, "_PLANS", precision._Plans())
    precision.cap_device_memory(10, "cuda:0")
    precision.cap_device_memory(None, "cuda:0")
    assert calls == ["gc", "sync", "empty", ("cap", 0.125, 0),
                     "gc", "sync", "empty", ("cap", 1.0, 0)]
    assert precision._PLANS.fraction == {0: 1.0}


def _lhbdc_coder():
    from tpuvc_torch.models.lhbdc import LHBDC, LHBDCCoder

    return LHBDCCoder(LHBDC(N=16, generator=torch.Generator().manual_seed(0)), device="cuda")


def _dmc_coder():
    from tpuvc_torch.models.dmc import PFrameDMC, PFrameDMCCoder

    return PFrameDMCCoder(PFrameDMC(feat=16, N=32, generator=torch.Generator().manual_seed(0)),
                          device="cuda")


def _cli(name, argv):
    def run(tmp_path):
        import importlib

        return importlib.import_module(f"tpuvc_torch.cli.{name}").main(
            [a.replace("TMP", str(tmp_path)) for a in argv])
    return run


ENTRY_POINTS = {
    "encode_v": _cli("encode_v", ["--synthetic", "3", "--width", "64", "--height", "64",
                                  "--init", "random", "--bin", "TMP/x.tpvb"]),
    "decode_v": _cli("decode_v", ["--bin", "TMP/missing.tpvb", "--out_dir", "TMP/d"]),
    "encode_p": _cli("encode_p", ["--synthetic", "3", "--init", "random", "--bin", "TMP/x.tpvs"]),
    "decode_p": _cli("decode_p", ["--bin", "TMP/missing.tpvs", "--out_dir", "TMP/d"]),
    "train": _cli("train", ["model.family=lhbdc", "model.N=16", "checkpoint_dir=TMP/ck",
                            "workers=0", "prefetch=0"]),
    "lhbdc_coder": lambda tmp_path: _lhbdc_coder(),
    "dmc_coder": lambda tmp_path: _dmc_coder(),
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_refuses_without_the_budget(card, entry, tmp_path):
    """With less free memory than the budget, an entry point stops before
    it codes or trains anything, and the error names the GiB it needs."""
    card.free = int(0.5 * GIB)
    with pytest.raises(precision.ConvWorkspaceError,
                       match=f"needs {precision.CONV_WORKSPACE_GIB} GiB"):
        ENTRY_POINTS[entry](tmp_path)
    assert card.observers == []
    assert not torch.are_deterministic_algorithms_enabled()


def test_a_failed_allocation_refuses_other_plans():
    """The observer raises where PyTorch would let cuDNN take a plan with a
    smaller workspace, naming the allocation and the budget."""
    with pytest.raises(precision.ConvWorkspaceError,
                       match=f"1.50 GiB .*plus {precision.CONV_WORKSPACE_GIB} GiB"):
        precision._refuse_other_plans(0, int(1.5 * GIB), 70 * GIB, GIB // 2)


def test_deterministic_training_restores_the_mode(monkeypatch):
    """PyTorch's deterministic algorithms, with cuBLAS's deterministic
    workspace setting, inside the context only."""
    monkeypatch.delenv("CUBLAS_WORKSPACE_CONFIG", raising=False)
    assert not torch.are_deterministic_algorithms_enabled()
    with precision.deterministic_training("cpu"):
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert os.environ["CUBLAS_WORKSPACE_CONFIG"] == precision.CUBLAS_WORKSPACE_CONFIG
    assert not torch.are_deterministic_algorithms_enabled()
    with pytest.raises(ValueError), precision.deterministic_training("cpu"):
        raise ValueError
    assert not torch.are_deterministic_algorithms_enabled()


#: Narrow widths of the families whose sampled inputs take gradients: the
#: deform and feature warps (DeformB, FlowGuidedB) and DMC's 48-channel
#: feature warp (tests/test_torch_train_cli.py's widths).
NARROW = {
    "deform_b": ["model.N=32", "model.levels=2"],
    "flowguided_b": ["model.N=32", "model.levels=2", "model.feature_channels=(16,32,48)"],
    "dmc": ["n_pframes=2"],
}


@pytest.mark.parametrize("family", list(NARROW))
def test_two_training_runs_are_bit_identical(family, tmp_path):
    """The train CLI twice from one seed and one batch stream, under its
    deterministic_training, both stages of the recursive families: the
    same parameter bits (the summary's digest) and the same metrics."""
    from tpuvc_torch.cli import train

    runs = []
    for k in range(2):
        runs.append(train.main([
            "--device", "cpu", f"model.family={family}", *NARROW[family], "batch_size=2",
            "crop=64", "total_steps=2", "stage2_start=1", "val_every=100", "workers=0",
            "prefetch=0", "dataset_root=/nonexistent", f"checkpoint_dir={tmp_path}/{k}"]))
    assert runs[0]["params_sha256"] == runs[1]["params_sha256"]
    assert runs[0]["metrics"] == runs[1]["metrics"]
    assert not torch.are_deterministic_algorithms_enabled()
