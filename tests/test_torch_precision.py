"""The port's entry points compute in float32 whatever torch's global TF32
flags say (utils/precision.py), on the CPU at batch 2.

With both flags set True by the caller (``torch.backends.cudnn.allow_tf32``
and ``torch.backends.cuda.matmul.allow_tf32``, torch's default on a card
being True for cuDNN), a forward hook on the model's convolutions records
both flags while the model runs: inside every public entry point they read
False, and after it True again.  On the CPU the flags change no result;
they are what the card's cuDNN and cuBLAS read.  Also: ``float32()``
restores the flags after an error, keeps them off while sections
overlap in two threads, leaves torch's newer API
(``torch.backends.*.fp32_precision``) as it found it, and refuses with a
clear error, changing nothing, a state that newer API set where the
per-library flags cannot be read.
"""

import sys
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from polardepth_tpu_torch import cli, config
from polardepth_tpu_torch.data.synthetic import SyntheticHammer
from polardepth_tpu_torch.eval.export import (
    load_module, make_export, save_artifact)
from polardepth_tpu_torch.train import loop, state
from polardepth_tpu_torch.train.trainer import (
    Predictor, Trainer, build_model, make_eval_step, make_infer_step,
    make_train_step)
from polardepth_tpu_torch.utils.precision import float32

H, W = 64, 96
# the flags, read and written as the port's float32() does them
_flags = chip_smoke.tf32_flags
_set_flags = chip_smoke.set_tf32_flags


def _new_api():
    """torch's newer per-operator precision settings, every level."""
    b = torch.backends
    return (b.fp32_precision, b.cudnn.fp32_precision,
            b.cudnn.conv.fp32_precision, b.cudnn.rnn.fp32_precision,
            b.cuda.matmul.fp32_precision)


@pytest.fixture
def tf32_on():
    """Both flags True for the test, the caller's flags back after it."""
    with chip_smoke.tf32_on():
        yield


@pytest.fixture(autouse=True)
def _one_thread(monkeypatch):
    """One intra-op thread beside the other test workers, no TensorBoard."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def seen():
    """The flags at every convolution module's (and loaded program's)
    forward while the test runs."""
    record = []

    def hook(module, args, output):
        if isinstance(module, (torch.nn.Conv2d, torch.fx.GraphModule)):
            record.append(_flags())

    handle = torch.nn.modules.module.register_module_forward_hook(hook)
    yield record
    handle.remove()


def _cfg(**kw):
    base = dict(height=H, width=W, batch_size=2, num_epochs=1,
                dropout_rate=0.0)
    base.update(kw)
    return config.PUBLISHED.replace(**base)


def _alt_cfg(**kw):
    return _cfg(height=32, width=32, depth_supervision_only=False,
                num_depth_bins=16, **kw)


def _weights(cfg):
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        return build_model(cfg).state_dict()


def _quiet_trainer(cfg):
    return Trainer(cfg, steps_per_epoch=1, device="cpu",
                   log_fn=lambda *_: None)


def _batch():
    return SyntheticHammer(H, W, seed=3).batch(2)


def _alt(cfg):
    args = type("A", (), {"synthetic": 2})
    data, spe = cli._make_multiframe_data(cfg, args, "train")
    alt = loop.make_alt_trainer(cfg, spe, device="cpu",
                                log_fn=lambda *_: None)
    return alt, data, spe


def _predictor(tmp_path):
    cfg = _cfg()
    Predictor(cfg, _weights(cfg), device="cpu").predict(_batch())


def _train_step(tmp_path):
    cfg = _cfg()
    model = build_model(cfg)
    step = make_train_step(model, cfg)
    batch = {k: _batch()[k] for k in ("color", "pol", "depth", "K")}
    step(state.create_train_state(model, cfg), batch,
         torch.Generator().manual_seed(0))


def _eval_step(tmp_path):
    cfg = _cfg()
    from polardepth_tpu_torch.eval.evaluation import empty_accumulator
    batch = {k: torch.as_tensor(v) for k, v in _batch().items()
             if k in ("color", "pol", "depth_gt", "mask")}
    make_eval_step(build_model(cfg), cfg)(batch, empty_accumulator("cpu"))


def _infer_step(tmp_path):
    cfg = _cfg()
    batch = {k: torch.as_tensor(_batch()[k]) for k in ("color", "pol")}
    make_infer_step(build_model(cfg), cfg)(batch)


def _trainer_evaluate(tmp_path):
    _quiet_trainer(_cfg()).evaluate([_batch()])


def _trainer_predict(tmp_path):
    _quiet_trainer(_cfg()).predict(_batch())


def _trainer_fit(tmp_path):
    batch = _batch()
    _quiet_trainer(_cfg()).fit(lambda: iter([batch]), lambda: iter([batch]),
                               num_epochs=1)


def _alt_evaluate(tmp_path):
    alt, data, _ = _alt(_alt_cfg())
    alt.evaluate(data())


def _alt_fit(tmp_path):
    alt, data, spe = _alt(_alt_cfg())
    alt.fit(data, data, 1, steps_per_epoch=spe)


def _selfsup_step(tmp_path):
    alt, data, _ = _alt(_alt_cfg())
    alt.train_step(next(data()))


def _student_step(tmp_path):
    alt, data, _ = _alt(_alt_cfg(train_student=True))
    alt.train_step(next(data()))


def _export(tmp_path):
    cfg = _cfg(height=32, width=32)
    make_export(cfg, _weights(cfg), batch=2, device="cpu")


def _loaded_program(tmp_path):
    cfg = _cfg(height=32, width=32)
    path = str(tmp_path / "model.pt2")
    _set_flags(False, False)          # the export is another entry point
    save_artifact(make_export(cfg, _weights(cfg), batch=2, device="cpu"),
                  path, cfg)
    _set_flags(True, True)
    load_module(path)(torch.zeros(2, 32, 32, 3, dtype=torch.uint8),
                      torch.zeros(2, 32, 32, 4, dtype=torch.uint8))


def _cli_evaluate(tmp_path):
    cli.main(["evaluate", "--synthetic", "2", "--height", str(H), "--width",
              str(W), "--batch_size", "2", "--device", "cpu"])


ENTRY_POINTS = {
    "Predictor.predict": _predictor,
    "make_train_step": _train_step,
    "make_eval_step": _eval_step,
    "make_infer_step": _infer_step,
    "Trainer.evaluate": _trainer_evaluate,
    "Trainer.predict": _trainer_predict,
    "Trainer.fit": _trainer_fit,
    "AltTrainer.evaluate": _alt_evaluate,
    "AltTrainer.fit": _alt_fit,
    "make_selfsup_train_step": _selfsup_step,
    "make_student_train_step": _student_step,
    "make_export": _export,
    "load_module": _loaded_program,
    "cli.main evaluate": _cli_evaluate,
}


@pytest.mark.parametrize("entry", list(ENTRY_POINTS))
def test_entry_point_runs_its_convolutions_in_float32(entry, tf32_on, seen,
                                                      tmp_path, capsys):
    ENTRY_POINTS[entry](tmp_path)
    assert seen, f"{entry}: no convolution ran"
    assert set(seen) == {(False, False)}
    assert _flags() == (True, True)


def test_entry_points_leave_the_flags_off_when_the_caller_had_them_off(
        seen):
    saved = _flags()
    _set_flags(False, False)
    try:
        _predictor(None)
        assert set(seen) == {(False, False)}
        assert _flags() == (False, False)
    finally:
        _set_flags(*saved)


def test_float32_restores_the_flags_after_an_error(tf32_on):
    with pytest.raises(ValueError, match="planted"):
        with float32():
            assert _flags() == (False, False)
            raise ValueError("planted")
    assert _flags() == (True, True)


def test_float32_nests_and_decorates(tf32_on):
    @float32()
    def inner():
        return _flags()

    with float32():
        assert inner() == (False, False)
        assert _flags() == (False, False)
    assert inner() == (False, False)
    assert _flags() == (True, True)


@pytest.mark.parametrize("caller", ["tf32 on", "default", "off"])
def test_float32_leaves_the_newer_api_as_it_found_it(caller):
    """Whatever the caller's flags, the newer API's every level reads the
    same after float32() as before it: the round trip mixes nothing."""
    saved = _flags()
    _set_flags(*{"tf32 on": (True, True), "default": (True, False),
                 "off": (False, False)}[caller])
    try:
        before = _new_api(), _flags()
        with float32():
            assert _flags() == (False, False)
        assert (_new_api(), _flags()) == before
    finally:
        _set_flags(*saved)


def test_float32_under_the_newer_api_neither_raises_nor_mixes(tf32_on,
                                                              seen):
    """The caller turns cuDNN's TF32 on through the newer API; the entry
    point still sees both flags off, and the newer API's settings come back
    as the caller left them, every flag readable through either API."""
    torch.backends.cudnn.conv.fp32_precision = "tf32"
    before = _new_api()
    _predictor(None)
    assert set(seen) == {(False, False)}
    assert _new_api() == before
    assert torch.backends.cudnn.conv.fp32_precision == "tf32"
    assert _flags() == (True, True)


def test_float32_refuses_a_newer_api_state_it_cannot_read(tf32_on):
    """cuDNN's convolutions set apart from its recurrent layers through the
    newer API: torch will not read allow_tf32, so float32() raises its own
    error, naming the setting, and changes nothing."""
    torch.backends.cudnn.conv.fp32_precision = "ieee"
    try:
        before = _new_api()
        with pytest.raises(RuntimeError, match=r"float32\(\).*fp32_precision"):
            with float32():
                pass
        assert _new_api() == before
    finally:
        torch.backends.cudnn.conv.fp32_precision = "tf32"
    assert _flags() == (True, True)


def test_float32_sections_that_overlap_in_two_threads(tf32_on):
    """Thread A enters, then B; A leaves while B is still inside: B still
    reads both flags off, and the caller's come back once both have left."""
    a_in, b_in, a_out = (threading.Event() for _ in range(3))
    read = {}

    def a():
        with float32():
            a_in.set()
            assert b_in.wait(10)
            read["a"] = _flags()
        a_out.set()

    def b():
        assert a_in.wait(10)
        with float32():
            b_in.set()
            assert a_out.wait(10)
            read["b"] = _flags()

    threads = [threading.Thread(target=f) for f in (a, b)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(20)
    assert read == {"a": (False, False), "b": (False, False)}
    assert _flags() == (True, True)


def test_the_tf32_control_runs_the_convolutions_with_the_flags_on(seen,
                                                                   capsys):
    """chip_smoke.py's control for its precision check: the command line's
    evaluate with every module's forward under TF32-on flags, inside the
    entry points' float32().  Its convolutions see both flags on, so the
    card's reading of it is a TF32 one; the caller's flags come back."""
    saved = _flags()
    _set_flags(False, False)
    try:
        with chip_smoke.tf32_in_every_module():
            table, disps = chip_smoke.cli_evaluate(
                ("evaluate", "--synthetic", "2", "--height", "32", "--width",
                 "32", "--batch_size", "2", "--device", "cpu",
                 "--save_pred_disps"))
        assert seen and set(seen) == {(True, True)}
        assert _flags() == (False, False)
        assert "all" in table and disps.shape[0] == 2
        assert bool(np.isfinite(disps).all())
    finally:
        _set_flags(*saved)
