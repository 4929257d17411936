"""Command-line tools of the port.

- :mod:`.launch` — ``python -m tpu_mx_torch.tools.launch -n N <command>``
  starts N workers with the ``torch.distributed`` env protocol;
  ``--supervise`` makes it the controller of an elastic fleet.
- :mod:`.fleet_report` — ``python tpu_mx_torch/tools/fleet_report.py
  <fleet-blackbox.json> [--validate]`` renders (and checks) a fleet black
  box without importing torch.
- :mod:`.im2rec` — ``python -m tpu_mx_torch.tools.im2rec [--list]
  PREFIX ROOT`` makes a ``.lst`` file, then packs it into ``.rec`` and
  ``.idx`` (``--native``: the C++ packer), byte-equal to the reference
  tool's files.
- :mod:`.telemetry_report`, :mod:`.blackbox_report`, :mod:`.slo_report`,
  :mod:`.capacity_report` — ``python tpu_mx_torch/tools/<tool>.py FILE
  [--validate]`` render (and check) a telemetry JSONL file, a black box,
  the SLO windows and the capacity ledger without importing torch.
- :mod:`.parse_log` — ``python tpu_mx_torch/tools/parse_log.py LOG``
  tabulates ``Speedometer``/``Module.fit`` logs per epoch.
"""
