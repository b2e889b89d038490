"""phonic_tpu — a batched audio rendering engine in JAX.

A ground-up rebuild of the capabilities of emuell/phonic (a Rust real-time
audio playback + DSP library) designed for XLA: render graphs compile to
single jitted block programs, recursive DSP runs as parallel associative
scans, voices/grains/stems batch under vmap, and sample-accurate event
scheduling lowers to closed-form parameter ramps.
"""

from .config import EngineConfig, DEFAULT_CONFIG
from .errors import (
    PhonicError, MediaFileError, UnsupportedFormatError, OutputDeviceError,
    ResamplingError, NotFoundError, ParameterError, SendError,
)
from .graph.mixer import Mixer
from .graph.engine import RenderProgram
from .sources.file import FileSource, FilePlaybackOptions
from .sources.synth import SynthDef, SynthPlaybackOptions, SynthSource
from .generators.base import Generator, GeneratorPlaybackOptions
from .generators.sampler import AhdsrConfig, Sampler
from .generators.granular import GranularConfig
from .generators.synth import SynthGenerator
from .modulation.config import (
    EnvelopeSource, KeytrackingSource, LfoSource, ModulationConfig,
    VelocitySource,
)
from .player import (
    AudioLevel, CpuLoad, EffectHandle, GeneratorPlaybackHandle, MixerHandle,
    PlaybackHandle, PlaybackStatusEvent, Player, PlayerConfig,
)
from .graph.nodes import Effect, Source
from .params import (
    BooleanParameter, DecibelScaling, EnumParameter, ExponentialScaling,
    FloatParameter, IntegerParameter, LinearScaling, Scaling, SigmoidScaling,
    db_to_linear, linear_to_db,
)
from .outputs.base import OutputDevice, default_output_device
from .io.decoder import AudioFileBuffer, AudioFileInfo, file_info, register_decoder

__version__ = "0.1.0"
