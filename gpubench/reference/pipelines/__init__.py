"""The reference of each kind of configuration, one module a kind.

A configuration's module is the one its file's top-level ``"reference"``
names, or else ``<detector>_<strategy>`` after its ``model.detector``
(lower case) and ``cropper.strategy`` (:func:`gpubench.harness.spec.
pipeline_name`): a configuration whose module is missing cannot be
judged, and its cell does not run.  A configuration with more networks
than the detector (an enhancer, a parser) names its own module, so that it
is never judged by the detector's alone.

A module holds:

* ``networks(model)``: name → plain network at the ``model`` block's
  widths, weights to be loaded; each name is also the configuration's
  ``weights`` entry;
* ``SERVED_BY``: name → the ``Cropper`` attribute whose ``.net`` serves
  that network in the package (every network of ``networks``);
* ``faces(nets, model, images, interim, threshold)``: the faces the
  strategy keeps of a uniform uint8 (N, H, W, 3) batch on the device,
  as (landmarks (F, 5, 2) in source pixels, image index (F,)), in the
  package's order;
* ``image_flop(h, w, interim, model)``: the counted FLOPs of one h×w
  image (``gpubench/counts``).

and, where the default does not describe what the package does, two
optional functions:

* ``crops(cell, nets, images, offset=None, windows=None)``: the
  reference's (uint8 crops (F, Ho, Wo, 3), image indices (F,)) of a
  uniform uint8 batch on the device, in the package's order, with the
  arguments of :meth:`gpubench.harness.cell.Cell.reference_crops`.  The
  default is ``faces``, less ``offset``, warped from ``images`` inside
  each image's ``windows`` row; :meth:`~gpubench.harness.cell.Cell.
  warp_faces` fits and warps faces from any uint8 rows the module makes
  (a gated enhancer's enhanced rows), each face with its own row and
  window;
* ``window_flop(run, stats)``: the counted FLOPs of the traced window,
  from the entry ``run`` (its ``images_done()``, ``model`` and ``kw``)
  and ``stats``, the window's ``Cropper.stats`` delta (name →
  ``seconds``, ``calls``, ``items``), whose ``det_net``, ``enh_net`` and
  ``parse_net`` items are the rows each network ran.  The default is the
  sum of ``image_flop`` over ``images_done()``.  Counts come from the
  published shapes times the rows that ran, never from the kernels a run
  picked.
"""
