#!/bin/sh
# Build the native host-side components into libmupe_native.so (or into the
# path given as the first argument).
set -e
cd "$(dirname "$0")"
out="${1:-libmupe_native.so}"
g++ -O2 -shared -fPIC -std=c++17 -o "$out" easy_tasks.cpp
echo "built $out"
