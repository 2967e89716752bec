"""The reference against the port's CPU path at a tiny size.

With the configuration's fp32 arms the port on the CPU runs its plain
versions, so the two agree to fp32 round-off: every number a cell
compares reads under a tenth of its limit (train: the losses, the first
gradient and the change after three steps, and the losses, the leaves'
and the moments' changes over the timed window's first call; render: the
views). This test
may import both; the reference imports nothing of the port
(test_portbench_isolation)."""

import pytest

from portbench.tests import tiny


@pytest.mark.parametrize("mix", ["train_all", "train_radiance", "render"])
def test_reference_agrees_with_the_port(tmp_path, mix):
  result, checks = tiny.run(tmp_path, mix, seconds=0.2)
  assert checks
  for name, (value, limit) in checks.items():
    # An exact comparison (limit 0) has to read 0.
    assert value < 0.1 * limit or value == limit == 0, (name, value, limit)
  assert result["correct"] and result["attempted"] >= 1
