"""audio_io tests against a fake (loopback) sounddevice backend.

The reference leaves hardware IO untested ("Tests for audio io module
should be manual", reference `tests/test_audio_io.py:1-4`); here a fake
backend exercises the full API: playback, recording, duplex loopback,
device/default configuration. The fake mirrors the sounddevice call
surface the reference uses (`input_mapping`/`output_mapping`/`mapping`
1-based channel selectors, `sd.default`, `sleep(ms)`).
"""

import sys
import types

import numpy as np
import pytest

import dsptoolbox_jax as dsp


@pytest.fixture
def fake_sd(monkeypatch):
    """Install a loopback sounddevice fake for the duration of a test."""
    sd = types.ModuleType("sounddevice")
    state = {"played": None, "slept_ms": None}

    sd.default = types.SimpleNamespace(
        device=None, samplerate=None, blocksize=None, latency=None
    )

    class DeviceList(list):
        pass

    sd.DeviceList = DeviceList
    sd.query_devices = lambda *a, **k: (
        {"name": "fake", "index": a[0]} if a else DeviceList(
            [{"name": "fake", "index": 0}, {"name": "other", "index": 1}]
        )
    )

    def playrec(data, samplerate, input_mapping, output_mapping,
                blocking=True, **kw):
        state["played"] = np.array(data)
        out = np.zeros((len(data), len(input_mapping)))
        # loopback: copy first played channel into every record channel
        for c in range(len(input_mapping)):
            out[:, c] = np.asarray(data)[:, 0]
        return out

    def rec(frames, samplerate, mapping, blocking=True, **kw):
        rng = np.random.default_rng(0)
        return rng.standard_normal((frames, len(mapping))) * 1e-3

    def play(data, samplerate, mapping=None, blocking=True, **kw):
        state["played"] = np.array(data)

    sd.playrec, sd.rec, sd.play = playrec, rec, play

    def _sleep(ms):
        state["slept_ms"] = ms

    sd.sleep = _sleep

    class CallbackStop(Exception):
        pass

    sd.CallbackStop = CallbackStop

    class OutputStream:
        def __init__(self, *a, **k):
            self.kwargs = k

    sd.OutputStream = OutputStream

    monkeypatch.setitem(sys.modules, "sounddevice", sd)
    return sd, state


def _tone(fs=8000, n=4000):
    t = np.arange(n) / fs
    return dsp.Signal(
        None, (0.3 * np.sin(2 * np.pi * 440 * t))[:, None], fs
    )


class TestAudioIO:
    def test_defaults_and_device(self, fake_sd):
        sd, _ = fake_sd
        dsp.audio_io.set_latency(True, False)
        assert sd.default.latency == ("low", "high")
        dsp.audio_io.set_blocksize(256)
        assert sd.default.blocksize == 256
        dsp.audio_io.set_device(0, sampling_rate_hz=44100)
        assert sd.default.device == 0
        assert sd.default.samplerate == 44100
        # name-substring device selection
        dsp.audio_io.set_device("other")
        assert sd.default.device == 1
        # 2-list of indices
        dsp.audio_io.set_device([0, 1])
        assert sd.default.device == [0, 1]
        assert dsp.audio_io.default_config.blocksize == 256

    def test_print_device_info(self, fake_sd):
        info = dsp.audio_io.print_device_info(device_number=0)
        assert info is not None

    def test_play(self, fake_sd):
        _, state = fake_sd
        s = _tone()
        dsp.audio_io.play(s, normalized_dbfs=None)
        np.testing.assert_allclose(state["played"], s.time_data)
        # peak normalization to -6 dBFS
        dsp.audio_io.play(s)
        peak = np.max(np.abs(state["played"]))
        np.testing.assert_allclose(peak, 10 ** (-6 / 20), rtol=1e-6)

    def test_play_and_record_loopback(self, fake_sd):
        s = _tone()
        rec = dsp.audio_io.play_and_record(
            s, normalized_dbfs=None, rec_channels=[1, 2]
        )
        assert rec.number_of_channels == 2
        assert rec.sampling_rate_hz == s.sampling_rate_hz
        np.testing.assert_allclose(
            rec.time_data[:, 0], s.time_data[:, 0], atol=1e-12
        )

    def test_record(self, fake_sd):
        rec = dsp.audio_io.record(
            duration_seconds=0.5, sampling_rate_hz=8000
        )
        assert len(rec) == 4000
        assert rec.sampling_rate_hz == 8000

    def test_sleep_and_output_stream(self, fake_sd):
        _, state = fake_sd
        dsp.audio_io.sleep(0.25)
        assert state["slept_ms"] == 250
        stream = dsp.audio_io.output_stream(_tone(), blocksize=128)
        assert stream.kwargs["blocksize"] == 128
        assert stream.kwargs["channels"] == 1
