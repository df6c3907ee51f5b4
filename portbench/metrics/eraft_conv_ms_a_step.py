"""Device ms a step of the kernels that metrics/eraft_conv_kernels.txt
names (cuDNN's and cuBLAS's convolutions, GEMMs and layout transposes of
E-RAFT's encoders and update block); None where nothing matched."""
from pathlib import Path

PATTERNS = Path(__file__).resolve().parent / 'eraft_conv_kernels.txt'


def read(rec):
    patterns = [line.strip() for line in PATTERNS.read_text().splitlines()
                if line.strip() and not line.startswith('#')]
    spent = rec.trace.seconds(patterns)
    return 1e3 * spent / rec.trace.steps if spent > 0 else None
