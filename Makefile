# Tier-1 verification in one word: `make test`.
PYTHON ?= python
export PYTHONPATH := src$(if $(PYTHONPATH),:$(PYTHONPATH))

.PHONY: test test-fast test-conformance test-kernels test-alloc \
    test-scheduling test-http test-prefix test-precision test-retrace \
    test-swap test-ci test-torch lint docs-check dev serve bench

test:
	$(PYTHON) -m pytest -x -q

# repo-specific invariant lint (tools/analyze): retrace safety, host-sync
# lint over the decode hot loop, allocator/scheduler host purity, kernel
# triple completeness, conformance-axis coverage — plus the docs checks.
# Static only; the runtime zero-retrace proof is `make test-retrace`.
lint:
	$(PYTHON) -m tools.analyze
	$(PYTHON) tools/check_docs.py

# runtime retrace guard: a live engine must compile ZERO new XLA programs
# at steady state (admission/fold/deferral/preempt+recompute, both backends)
test-retrace:
	$(PYTHON) -m pytest -x -q tests/test_retrace.py tests/test_analyze.py

# skip the slow integration files while iterating
test-fast:
	$(PYTHON) -m pytest -x -q tests/test_kvcache.py tests/test_quant.py \
	    tests/test_saliency.py tests/test_serving.py \
	    tests/test_backend_conformance.py tests/test_page_alloc.py

# cross-backend (mixed vs paged-static vs paged-kernel vs paged-freelist)
# cache-layout conformance suite
test-conformance:
	$(PYTHON) -m pytest -x -q tests/test_backend_conformance.py

# free-list page allocator: grant/free invariants, occupancy mirror,
# fragmentation reuse, engine admission deferral
test-alloc:
	$(PYTHON) -m pytest -x -q tests/test_page_alloc.py

# scheduler/streaming/preemption: typed errors, priority ordering,
# preempt+recompute bitwise identity + allocator invariants, and the
# streaming-conformance check from the cross-backend suite
test-scheduling:
	$(PYTHON) -m pytest -x -q tests/test_scheduling.py \
	    "tests/test_backend_conformance.py::test_streaming_concat_matches_result"

# HTTP/SSE front + replica router: drive-loop backoff, SSE bitwise identity,
# disconnect/deadline/endpoint cancellation, least-loaded placement and
# session affinity, and the serve/serve_http argparse guard rails
test-http:
	$(PYTHON) -m pytest -x -q tests/test_http.py

# shared-prefix dedup: refcount/CoW allocator invariants, the bitwise
# shared-system-prompt conformance scenario, and the zero-compile
# alias/privatize steady-state proof
test-prefix:
	$(PYTHON) -m pytest -x -q \
	    "tests/test_page_alloc.py::test_prefix_invariants_random_sequences" \
	    "tests/test_page_alloc.py::test_prefix_invariants_deterministic_sweep" \
	    "tests/test_page_alloc.py::test_alias_write_privatize_roundtrip" \
	    "tests/test_page_alloc.py::test_sole_referent_alias_is_adopted_without_copy" \
	    "tests/test_page_alloc.py::test_regrant_of_still_referenced_page_asserts" \
	    "tests/test_page_alloc.py::test_register_refused_without_slack_is_not_corrupting" \
	    "tests/test_backend_conformance.py::test_continuous_engine_token_identical_with_prefix_cache" \
	    "tests/test_backend_conformance.py::test_prefix_cache_shared_prompt_dedup_bitwise" \
	    "tests/test_retrace.py::test_prefix_cache_engine_zero_compiles_at_steady_state"

# adaptive precision: map parsing/algebra + kernel-vs-oracle under
# heterogeneous maps, the effective-bits property suite, the precision-map
# conformance axis + downshift pressure scenario, the downshift-storm
# allocator regression, and both zero-compile steady-state proofs
test-precision:
	$(PYTHON) -m pytest -x -q tests/test_precision.py
	$(PYTHON) -m pytest -x -q -k "eff or precision or downshift or raw16" \
	    tests/test_quant.py tests/test_backend_conformance.py \
	    tests/test_page_alloc.py tests/test_retrace.py

# host swap tier: pool/allocator roundtrip invariants (partition, host-byte
# conservation, refusal counting), the bitwise swap == recompute ==
# uncontended pressure scenario + the unpressured conformance axis, the
# aging/starvation scheduler tests, and the zero-compile swapping proof
test-swap:
	$(PYTHON) -m pytest -x -q -k "swap or aging" \
	    tests/test_page_alloc.py tests/test_backend_conformance.py \
	    tests/test_scheduling.py tests/test_retrace.py

# README/docs stay mechanically honest: flag tables vs the live argparse
# surface, python snippets parse, referenced paths exist (tools/check_docs.py)
docs-check:
	$(PYTHON) tools/check_docs.py

# Pallas kernel conformance (interpret mode on CPU): cst_quant, probe_flash,
# decode_qattn, and the paged decode-attention kernel vs its oracles
test-kernels:
	$(PYTHON) -m pytest -x -q tests/test_kernels.py tests/test_paged_qattn.py

# CI entry point: the FULL suite under the pinned jax 0.4.37 (the former
# test_pipeline/test_roofline exclusions are gone — mesh construction and
# the HLO cost parser now work against the pinned API).  PYTEST_ARGS lets
# the workflow deselect the files its fast-signal steps already ran.
test-ci:
	$(PYTHON) -m pytest -q tests/ $(PYTEST_ARGS)

# the PyTorch/CUDA port (src/repro_torch) against the JAX package, on the
# CPU: kernels take their plain PyTorch versions, tests marked `gpu` skip
test-torch:
	$(PYTHON) -m pytest -q tests/test_torch_*.py

dev:
	$(PYTHON) -m pip install -r requirements-dev.txt

serve:
	$(PYTHON) -m repro.launch.serve --arch yi-6b --smoke --continuous \
	    --policy zipcache --batch 4 --prompt-len 64 --max-new 32

bench:
	$(PYTHON) benchmarks/run.py
