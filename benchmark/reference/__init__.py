"""The plain references that decide ``correct``.

A configuration names its reference by the optional key ``"reference"``
of ``benchmark/configs/<name>.json``: ``"<module>"`` is
``benchmark/reference/<module>.py``, and a configuration without the key
is judged by ``sift``.  ``benchmark/lib/spec.py:reference_of`` resolves
the name; the run (``run.py``: settings, ``plan_info``, the check), the
check (``lib/check.py``) and the control (``control.py``) all call the
module it returns.  ``match`` is the matcher of every configuration's
pairs and is no configuration's reference.

A reference module exports:

* ``settings_of(popsift_config) -> dict``: the configuration's
  ``popsift_config`` with the defaults filled in, raising on any setting
  it does not implement;
* ``make_plan(settings, w, h)``: the plan of one input size, with
  ``.dims`` (each octave's (width, height)) and ``.levels``;
* ``gauss_tables(settings)``: ``(inc, dd)``, each a list of
  ``(taps, span)``; ``inc``'s spans feed ``pyramid_roofline``'s work;
* ``extract(image, settings, device, pyramid_dtype=torch.float32) ->
  dict``: the features of one image in the layout that
  ``lib/judge.py:reference_features`` reads (numpy ``xpos``, ``ypos``,
  ``sigma``, ``num_ori``, ``orientation`` (n, 4), ``debug_octave``,
  ``desc_idx`` (n, 4) into ``descriptors`` (rows, 128)).

``extract`` takes the image exactly as the program was given it, uint8
or float32 (the configuration's ``"image_mode"``).  The check runs it
in float32 with TF32 off; with ``pyramid_dtype=torch.bfloat16`` (and
TF32 on) it is the control.  A reference imports nothing of the program
and takes nothing the program made.  It may import
``benchmark.reference.sift`` and reuse its functions, so that a new
configuration's reference is ``sift`` plus what that configuration adds.
"""
