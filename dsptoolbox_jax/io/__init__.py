"""Audio file IO (host-side).

WAV reading/writing is implemented directly over the RIFF container (stdlib +
numpy, including 24-bit packing); FLAC decoding is provided by the native C++
decoder in `dsptoolbox_jax/native` (no soundfile/ffmpeg dependency in this
environment). All readers return float64 in [-1, 1) shaped
``(samples, channels)`` like soundfile, the convention the reference package
uses (`classes/signal.py:106`).
"""

from .wav import read_wav, write_wav
from .audio import read_audio, write_audio
from .serialization import save_object, load_object

__all__ = [
    "read_audio",
    "write_audio",
    "read_wav",
    "write_wav",
    "save_object",
    "load_object",
]
