# Deployment image for meterelf-jax on an NVIDIA GPU (the host provides
# the driver; the CUDA libraries come with the jax[cuda12] wheels). The
# native JPEG decoder builds on first use with gcc against libjpeg-turbo.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
        gcc libjpeg62-turbo-dev \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY pyproject.toml README.md ./
COPY meterelf_jax ./meterelf_jax

RUN pip install --no-cache-dir ".[cuda12]"

ENTRYPOINT ["meterelf-jax"]

# --- dev stage: the type-correctness gate the build image can't run ---
# (the build sandbox has no network, so mypy cannot be installed there;
# tests/test_codequality.py::test_mypy_if_available runs the near-strict
# config in pyproject.toml whenever mypy IS present — this stage is where
# it always is. requirements.lock pins the validated runtime stack.)
FROM python:3.12-slim AS dev
RUN apt-get update && apt-get install -y --no-install-recommends \
        gcc libjpeg62-turbo-dev \
    && rm -rf /var/lib/apt/lists/*
WORKDIR /app
COPY pyproject.toml README.md requirements.lock ./
COPY meterelf_jax ./meterelf_jax
COPY tests ./tests
RUN pip install --no-cache-dir mypy pytest pyyaml numpy pillow scipy jax \
    && pip install --no-cache-dir --no-deps .
# the gate: near-strict mypy over the package (pyproject.toml [tool.mypy])
RUN python -m mypy meterelf_jax
