"""Multi-device proving over torch.distributed (counterpart of the JAX
package's parallel/): one process a device, NCCL between cards, gloo
between CPU ranks."""
