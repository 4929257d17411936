"""Command-line tools of the port.

- :mod:`.launch` — ``python -m tpu_mx_torch.tools.launch -n N <command>``
  starts N workers with the ``torch.distributed`` env protocol;
  ``--supervise`` makes it the controller of an elastic fleet.
- :mod:`.fleet_report` — ``python tpu_mx_torch/tools/fleet_report.py
  <fleet-blackbox.json> [--validate]`` renders (and checks) a fleet black
  box without importing torch.
"""
