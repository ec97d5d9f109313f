"""The port's solve plane: frontier pools, the BSP superstep (solo and
batched, B instances of P workers on one device), the lane state, startup
and result extraction."""
