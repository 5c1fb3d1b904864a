"""The Byzantine-robust server on the port's engines against the JAX
package: FedAvgSat under each of the four aggregators, FedBuffSat with the
trimmed mean in its flush, and AutoFLSat with the median in its tier 2,
all with 10-bit QuAFL, two rounds each.

Timing, selection, byte and ``clipped_updates`` fields are bitwise;
accuracy within ACC_TOL (``tests/test_torch_slice.py``)."""
import pytest

from test_torch_engines import assert_records_match, fl_kwargs, plans, \
    run_both  # noqa: F401  (plans is a fixture)


@pytest.mark.parametrize("algorithm,aggregator", [
    ("fedavg", "norm_clip"), ("fedavg", "trimmed_mean"),
    ("fedavg", "median"), ("fedavg", "krum"),
    ("fedbuff", "trimmed_mean"), ("autoflsat", "median")])
def test_robust_engine_matches_reference(plans, algorithm, aggregator):
    ref_res, port, port_res = run_both(
        plans, algorithm, fl_kwargs(10, 2, aggregator=aggregator))
    assert_records_match(ref_res, port_res, 2)
    assert port.algo.aggregator.name == aggregator
    if algorithm == "fedavg" and aggregator in ("median", "krum"):
        # over a 5-client cohort these estimators set rows aside
        assert port_res.summary()["clipped_updates"] > 0
