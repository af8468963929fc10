"""meterelf-jax: a JAX framework for reading analog water-meter dials
from webcam JPEG frames.

Same capabilities as the reference suutari/meterelf (YAML camera/dial
config, template-match dial localization, per-dial HLS masking and
needle-angle extraction, carry-corrected value assembly, per-image
graceful errors, offline calibration), rebuilt as one jit-compiled
batched JAX/XLA graph with byte-exact output parity against the
reference's golden test corpus.

Public surface mirrors the reference (meterelf/__init__.py) plus the
batched decoder for high-throughput use.
"""
from .api import MeterImageData, get_meter_values
from .params import Params, load as load_params
from .pipeline.decode import BatchResult, MeterDecoder

__all__ = [
    "MeterImageData",
    "get_meter_values",
    "Params",
    "load_params",
    "MeterDecoder",
    "BatchResult",
]

__version__ = "0.1.0"
