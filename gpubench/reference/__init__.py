"""Plain PyTorch and NumPy reference of what the benchmark's cells run.

Independent of the package under test: nothing here imports
``face_crop_plus_tpu_torch`` (nor JAX).  Each module follows the
published model or the documented semantics, in float32, with the
arithmetic written out in the order the package documents, so that a
sound float32 run of the package reads (nearly) nothing against it and a
run in a lower precision reads more.
"""
