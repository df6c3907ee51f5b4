"""Device ms a step of the kernels that metrics/predictor_kernels.txt
names (cuDNN's and cuBLAS's convolutions, GEMMs and layout transposes);
None where nothing matched."""
from harness.readers import predictor_patterns


def read(rec):
    spent = rec.trace.seconds(predictor_patterns())
    return 1e3 * spent / rec.trace.steps if spent > 0 else None
