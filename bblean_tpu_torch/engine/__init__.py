r"""The PyTorch port's engines.

- ``bblean_tpu_torch.engine.exact`` — bit-exact serial-equivalent BitBirch tree
  (``ExactTree``, host NumPy); ``bblean_tpu_torch.engine.native`` — the same
  insert loop in the native C++ library (``NativeExactTree``).
- ``bblean_tpu_torch.engine.batch`` — the level-synchronous batched engine on
  the device (``BatchTree``).
"""
