"""``python -m tdanet_tpu_torch.scripts.profile_train``: its command line
and its refusal to start without a card (the profile itself runs on the
card, in chip_smoke.py's phase 29), and the profiler rows it counts."""
import pytest
import torch

from tdanet_tpu_torch.scripts import profile_train


@pytest.mark.parametrize("argv,want", [
    ([], ("full", "build/train_trace", "adam")),
    (["scales", "out", "--optim", "lamb"], ("scales", "out", "lamb")),
    (["none", "--optim", "adafactor"],
     ("none", "build/train_trace", "adafactor"))])
def test_profile_train_command_line(monkeypatch, argv, want):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(profile_train, "profile", lambda *a: a)
    assert profile_train.main(argv) == want


def test_profile_train_refuses_an_unknown_mode(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(SystemExit):
        profile_train.main(["fast"])


def test_profile_train_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA card"):
        profile_train.main(["full"])


class _Event:
    def __init__(self, name, cuda, annotation=False):
        self.name = self.key = name
        self.is_user_annotation = annotation
        self.device_type = (torch.autograd.DeviceType.CUDA if cuda
                            else torch.autograd.DeviceType.CPU)


class _Window:
    """A profiled window's two views, as the profiler gives them: the
    events (the annotation flagged on the host side only) and the rows by
    key."""

    def __init__(self, rows, events):
        self._rows, self._events = rows, events

    def key_averages(self):
        return self._rows

    def events(self):
        return self._events


def test_device_kernels_leave_out_record_function_ranges():
    """torch.optim's "Optimizer.step#...": a range the profiler also puts
    on the device's timeline, which is no kernel; ``device_ranges`` gives
    what was left out."""
    from tdanet_tpu_torch.utils.timing import device_kernels, device_ranges
    mark = "Optimizer.step#Adafactor.step"
    rows = [_Event(mark, cuda=True), _Event("vectorized_elementwise", True),
            _Event("aten::mul", False)]
    events = [_Event(mark, cuda=False, annotation=True), *rows[1:]]
    window = _Window(rows, events)
    assert [e.key for e in device_kernels(window)] == [
        "vectorized_elementwise"]
    assert [e.key for e in device_ranges(window)] == [mark]
