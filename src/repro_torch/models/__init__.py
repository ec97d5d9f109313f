"""The LM serving path of the port: the transformer (dense, MoE, VLM patch
prefix) and RWKV6.

``registry.get_model(cfg)`` is the facade; ``convert`` carries the JAX
package's parameter trees across.  The other families (hybrid, encdec) and
training are refused with their ROADMAP item.
"""
