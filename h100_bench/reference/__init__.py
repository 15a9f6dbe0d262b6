"""The plain references the judge holds the program to: frozen copies that
import nothing of the program.

``detect.py`` is the Detection step's, for every configuration. The Flow
layer's is the configuration's own: ``reference/<name>.py``, named by the
configuration's ``flow_reference`` (``farneback`` where it names none) and
found by ``spec.flow_reference``. Such a module provides three names:

* ``flow(prev, curr, config, weights, precision="fp32")``: the flow from
  ``prev`` to ``curr``, (b, h, w, 2) float32. The frames come as the judge's
  ``Pair`` holds them, stacked on the judge's device: (b, h, w) gray or
  (b, h, w, 3) BGR uint8; the control gives it the frames as the program's
  flow function gets them. ``config`` is the whole configuration;
  ``weights`` is what ``weights`` drew. The judge hands it at most
  ``judge.BATCH`` pairs at a time; it may split them further to fit in
  memory. ``precision`` is ``"fp32"`` for the judge, ``CONTROL_PRECISION``
  for the control.
* ``weights(config, seed, device)``: a dict of named float32 tensors drawn
  on ``device`` from ``seed`` alone (the same seed, the same tensors), or
  None where the reference has none. The judge draws them itself from the
  run's seed and never reads the program's copy; a traffic kind gives its
  program the same draw from this function when it builds the model, so the
  two agree by construction, and only the judge's copy decides ``correct``.
* ``CONTROL_PRECISION``: the nearest precision below the configuration's
  in which ``flow`` runs as the control (``control.py``).
"""
