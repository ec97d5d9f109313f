"""The LM serving path of the port: the dense transformer and RWKV6.

``registry.get_model(cfg)`` is the facade; ``convert`` carries the JAX
package's parameter trees across.  The other families and training are
refused with their ROADMAP item.
"""
