"""End-to-end pipelines from BASELINE.md's benchmark configs, validated
against the reference oracle."""

import numpy as np
import pytest

import dsptoolbox_jax as dsp

EXAMPLE = "/root/reference/example_data"


class TestMusicFilterbankChain:
    """Config 3: fuer_elise -> LR crossover + gammatone + resampling."""

    def test_lr_gammatone_resample_chain(self, ref, close):
        s_m = dsp.pad_trim(dsp.Signal(f"{EXAMPLE}/fuer_elise.wav"), 2**15)
        s_r = ref.pad_trim(ref.Signal(f"{EXAMPLE}/fuer_elise.wav"), 2**15)

        fb_m = dsp.filterbanks.linkwitz_riley_crossovers(
            [500, 2000], order=4,
            sampling_rate_hz=s_m.sampling_rate_hz,
        )
        fb_r = ref.filterbanks.linkwitz_riley_crossovers(
            [500, 2000], order=4,
            sampling_rate_hz=s_r.sampling_rate_hz,
        )
        mb_m = fb_m.filter_signal(s_m, dsp.FilterBankMode.Parallel)
        mb_r = fb_r.filter_signal(s_r, ref.FilterBankMode.Parallel)
        for b in range(mb_m.number_of_bands):
            close(
                mb_m.bands[b].time_data, mb_r.bands[b].time_data,
                2e-5, f"elise LR band {b}",
            )

        # downsample the low band like a crossover-based processor would
        low_m = dsp.resample(mb_m.bands[0], 11025)
        low_r = ref.resample(mb_r.bands[0], 11025)
        close(low_m.time_data, low_r.time_data, 2e-5, "elise low resampled")

    def test_gammatone_analysis(self, ref, close):
        s_m = dsp.pad_trim(dsp.Signal(f"{EXAMPLE}/fuer_elise.wav"), 2**14)
        s_r = ref.pad_trim(ref.Signal(f"{EXAMPLE}/fuer_elise.wav"), 2**14)
        fs = s_m.sampling_rate_hz
        fb_m = dsp.filterbanks.auditory_filters_gammatone(
            [300, 2000], sampling_rate_hz=fs
        )
        fb_r = ref.filterbanks.auditory_filters_gammatone(
            [300, 2000], sampling_rate_hz=fs
        )
        mb_m = fb_m.filter_signal(s_m, dsp.FilterBankMode.Parallel)
        mb_r = fb_r.filter_signal(s_r, ref.FilterBankMode.Parallel)
        rec_m = fb_m.reconstruct(mb_m)
        rec_r = fb_r.reconstruct(mb_r)
        close(rec_m.time_data, rec_r.time_data, 2e-5, "elise gammatone rec")


class TestBatchedRIRDescriptors:
    """Config 4: descriptors over a batch of synthetic RIRs."""

    def test_batch_of_synthetic_rirs(self, ref):
        room_m = dsp.room_acoustics.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
        room_r = ref.room_acoustics.ShoeboxRoom([4.0, 3.0, 2.5], t60_s=0.4)
        rng = np.random.default_rng(0)
        positions = 1.0 + rng.uniform(0, 1, (4, 3))
        for pos in positions:
            rir_m = dsp.room_acoustics.generate_synthetic_rir(
                room_m, [1.0, 1.0, 1.0], pos, 16000, max_order=8
            )
            rir_r = ref.room_acoustics.generate_synthetic_rir(
                room_r, [1.0, 1.0, 1.0], pos, 16000, max_order=8
            )
            for desc in ("D50", "C80"):
                d_m = dsp.room_acoustics.descriptors(
                    rir_m,
                    getattr(dsp.room_acoustics.RoomAcousticsDescriptor,
                            desc),
                )
                d_r = ref.room_acoustics.descriptors(
                    rir_r,
                    getattr(ref.room_acoustics.RoomAcousticsDescriptor,
                            desc),
                )
                np.testing.assert_allclose(
                    d_m, d_r, rtol=5e-2, err_msg=f"{pos} {desc}"
                )


class TestSpeechSTFTChain:
    """Config 2: speech.flac -> STFT/ISTFT roundtrip + Welch/CSM."""

    def test_stft_istft_welch(self, ref, close):
        s_m = dsp.pad_trim(dsp.Signal(f"{EXAMPLE}/speech.flac"), 2**16)
        s_r = ref.pad_trim(ref.Signal(f"{EXAMPLE}/speech.flac"), 2**16)
        t_m, f_m, sp_m = s_m.get_spectrogram()
        t_r, f_r, sp_r = s_r.get_spectrogram()
        close(
            np.abs(np.asarray(sp_m)), np.abs(np.asarray(sp_r)),
            1e-4, "speech stft",
        )
        rec = dsp.transforms.istft(sp_m, original_signal=s_m)
        np.testing.assert_allclose(
            rec.time_data, s_m.time_data, atol=1e-5
        )
        f2_m, psd_m = s_m.get_spectrum()
        f2_r, psd_r = s_r.get_spectrum()
        close(
            np.asarray(psd_m), np.asarray(psd_r), 1e-3, "speech welch"
        )
