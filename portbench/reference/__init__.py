"""The plain reference of the benchmark: plain PyTorch in float32, with no
kernel, cache or batching of the program, and no import of it. It decides
whether what the program's timed path produced is correct."""
