"""Model configurations of the LM zoo: ``base.py`` (``ModelConfig``,
``ShapeConfig``, ``SHAPES``, ``ARCHS``, ``get_config``,
``reduced_config``) and one module per architecture.  Pure data, copied
field for field from the JAX package's ``configs/``."""
