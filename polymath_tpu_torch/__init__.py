"""Polymath zk-SNARK over BLS12-381 in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

The port of ``polymath_tpu`` (JAX + Pallas on a TPU).  Entry point::

    from polymath_tpu_torch.protocol import Polymath, Rng
    pm = Polymath(transcript=MerlinFieldTranscript)      # runs on the card
    pk, vk = pm.setup(circuit, Rng(0))
    proof = pm.prove(pk, circuit, rng)
    assert pm.verify(vk, public_inputs, proof)

``Polymath(..., device="cpu")`` runs every kernel's plain PyTorch version
instead (the CPU tests do this).
"""
