"""The LM serving path of the port: the transformer (dense, MoE, VLM patch
prefix), RWKV6, Griffin (recurrentgemma) and the encoder-decoder (whisper).

``registry.get_model(cfg)`` is the facade; ``convert`` carries the JAX
package's parameter trees across.  Training waits with its ROADMAP item.
"""
