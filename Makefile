# Build/test convenience targets (reference had a Makefile for nvcc —
# SURVEY.md C10; here the Python package needs no build step and the
# native ring library builds on first use, so these are developer
# shortcuts).

PY ?= python
CXX ?= g++
NATIVE_DIR := dsabeamformer/ingest/native

.PHONY: test native selftest bench clean

test:
	$(PY) -m pytest tests/ -q

native: $(NATIVE_DIR)/libdsaring.so

$(NATIVE_DIR)/libdsaring.so: $(NATIVE_DIR)/ring_buffer.cpp
	$(CXX) -O2 -std=c++17 -shared -fPIC $< -o $@ -lrt -pthread

selftest:
	$(PY) -m dsabeamformer.cli selftest

bench:
	$(PY) bench.py

clean:
	rm -f $(NATIVE_DIR)/libdsaring.so
	find . -name __pycache__ -type d -exec rm -rf {} + 2>/dev/null || true
