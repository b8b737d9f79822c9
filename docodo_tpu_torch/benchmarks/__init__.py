"""The port's counterparts of the JAX package's benchmarks/ scripts that
hold a TPU kernel: probe_locate.py, probe_dma_fetch.py and
profile_cap64.py, each runnable on the card as
`python -m docodo_tpu_torch.benchmarks.<name>`, with common.py, their
copy of what they take from benchmarks/common.py."""
