"""segquant: post-training int8 quantization of the zoo's forwards
(counterpart of rtseg_tpu/quant/).

Two halves, as in the JAX package:

  * :mod:`.ptq`: per-channel symmetric int8 weights on the Flax-shaped
    variables tree (scale = maxabs/127 over the output-channel axis), the
    dequantize-in-the-forward inference module whose `torch.export`
    artifact stores int8 constants and small f32 scale vectors, and the
    seeded scale-corruption knob;
  * :mod:`.calibrate`: deterministic calibration over a seeded sample
    slice (a segpipe PackedCache or the seeded synthetic source), optional
    per-tensor activation scales from the real eval forward, and the
    QuantRecord: scales hash, calibration hash, argmax agreement and mIoU
    delta against the f32 forward, gated by a max-drop threshold.

Every int8 -> float conversion of a quantized forward lives in this
package (tests/test_torch_quant.py walks the exported program to hold it).
"""

from .ptq import (QKIND, QMAX, build_quantized_inference_fn,
                  corrupt_scales, dequantize_params, fake_quant, is_qleaf,
                  quantize_params, quantize_variables, quantized_nbytes,
                  scale_fingerprint)
from .calibrate import (QuantRecord, calibrate, record_to_json,
                        select_calibration_indices)

__all__ = [
    'QKIND', 'QMAX',
    'build_quantized_inference_fn', 'corrupt_scales', 'dequantize_params',
    'fake_quant', 'is_qleaf', 'quantize_params', 'quantize_variables',
    'quantized_nbytes', 'scale_fingerprint',
    'QuantRecord', 'calibrate', 'record_to_json',
    'select_calibration_indices',
]
