"""Traffic kinds: one module per kind, found by the ``kind`` of a traffic
file (``kinds/<kind>.py``).  Each module gives ``Loop``, the closed-loop
client that drives a configuration's adapter
(``systems/<config>/<kind>.py``) through that kind of traffic, and
``CONTROL``, the precision of the control that its check is held
against (see ``control.py``).  A new kind of traffic adds a module here;
it edits none."""
