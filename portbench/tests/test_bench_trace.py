"""The trace's reduction: base names of kernels, the device's busy union,
idle gaps named by the innermost benchmark span open at their start."""

from tiny import ROOT  # noqa: F401  (puts the checkout on the path)

from portbench.harness.trace import Trace, base_name


def test_base_name():
    assert base_name("void at::native::vectorized_elementwise_kernel<4, "
                     "F>(int, F)") == "vectorized_elementwise_kernel"
    assert base_name("lstm_chain_fwd_kernel(float const*)") == \
        "lstm_chain_fwd_kernel"
    assert base_name("Memcpy HtoD (Pageable -> Device)") == \
        "Memcpy HtoD (Pageable -> Device)"
    assert base_name("void (anonymous namespace)::softmax_warp_forward"
                     "<float, 7>(float*, int)") == "softmax_warp_forward"


def test_busy_union_gaps_and_kernel_time():
    ops = [("a", 10, 20), ("b", 15, 30), ("a", 50, 60)]
    spans = [("trial", 0, 100), ("epoch.capture", 30, 50),
             ("score", 70, 90)]
    tr = Trace(ops, spans, (0, 100))
    assert tr.busy_s == 30e-9
    assert tr.window_s == 100e-9
    assert tr.kernel_seconds(["a"]) == 20e-9
    assert tr.top_ops(1) == [["a", 20e-9]]
    assert tr.idle_gaps() == [["trial", 40e-9], ["epoch.capture", 20e-9],
                              ["trial", 10e-9]]
