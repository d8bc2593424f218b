"""The bands within which a hand-written kernel's output is held against
its plain PyTorch version, and the capture thresholds the checks launch
the captures with: one table for ``chip_smoke.py``'s phases and the
sanitizer tier's cases (``sanitize.py``)."""

# a gate's score in nats, with the same -inf items
FWD_TOL = 1e-3
# decoding's posteriors, with the same ``ok``
DOMDEC_TOL = 1e-4
# the microbenchmarks' (tests/test_torch_ubench.py gives the reasons):
# the chain and the scalar rows an ulp a step (the kernels' FMA against
# the plain version's two roundings) that their map does not grow, the
# gather none (it adds in step order, as the plain version), the overlap
# one bf16 ulp of yacc; the tensor-core entry's is an ulp of the largest
# sum a step (ubench.onehot_mma_tol)
UB_TOL = {"ub_chain": 1e-6, "ub_onehot_gather": 0.0,
          "ub_overlap": 2.0 ** -8, "ub_scalars": 1e-6}
# capture thresholds: an SSV byte, a ViterbiFilter word, and one every
# row crosses
SSV_THR, VIT_THR, P1_THR = 180, 16_000, -(1 << 30)
