"""The parallel layer: sharding rules on DTensor and gradient compression.

* :mod:`repro_torch.parallel.sharding`: logical axes to mesh dimensions,
  each parameter's partition spec, and :func:`~repro_torch.parallel.sharding.constrain`
  at the model's activation sites (a no-op outside a ``sharding_env``);
* :mod:`repro_torch.parallel.compression`: top-k and int8 gradient
  compression with error feedback.
"""
