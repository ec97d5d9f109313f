"""The port's solve plane: frontier pools, the BSP superstep, startup and
result extraction, batched over P workers on one device."""
