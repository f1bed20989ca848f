"""The reference of each kind of configuration, one module a kind, named
``<detector>_<strategy>`` after the configuration's ``model.detector``
(lower case) and ``cropper.strategy``: a configuration whose module is
missing cannot be judged, and its cell does not run.

A module holds:

* ``networks(model)``: name → plain network at the ``model`` block's
  widths, weights to be loaded; each name is also the configuration's
  ``weights`` entry;
* ``SERVED_BY``: name → the ``Cropper`` attribute whose ``.net`` serves
  that network in the package;
* ``faces(nets, model, images, interim, threshold)``: the faces the
  strategy keeps of a uniform uint8 (N, H, W, 3) batch on the device,
  as (landmarks (F, 5, 2) in source pixels, image index (F,)), in the
  package's order;
* ``image_flop(h, w, interim, model)``: the counted FLOPs of one h×w
  image (``gpubench/counts``).
"""
