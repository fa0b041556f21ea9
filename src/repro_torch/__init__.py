"""PyTorch/CUDA port of the decentralized-encoding system.

Mirrors the JAX package's layout (`core/`, `kernels/`, `api/`, `recover/`,
`obs/`, `topo/`) so each module's counterpart has the same path, and imports
nothing of it.  The local backend's encode -> fail -> degraded read ->
rebuild path runs on one NVIDIA GPU through two hand-written CUDA kernels
(`csrc/gf_matmul.cu`, `csrc/ntt.cu`):

    from repro_torch.api import CodeSpec, CodedSystem

    system = CodedSystem(CodeSpec(kind="rs", K=16, R=4), backend="local")
    cw = system.codeword(x)        # numpy int64 in, numpy int64 out
    system.fail([2, 17]); x2 = system.read(cw); cw = system.rebuild(cw)

Entry points run on "cuda" unless given `device=` (the tests pass "cpu");
without a card they raise rather than fall back.
"""
