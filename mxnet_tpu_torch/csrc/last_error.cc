/*
 * last_error.cc: the error channel of src/recordio.cc's C API.
 *
 * recordio.cc reports a failure through MXTSetLastError, which it only
 * declares (C++ linkage), and callers read it back with MXTGetLastError
 * (src/mxtpu.h). Both are defined in src/engine.cc, which the port does
 * not build: this file defines them beside recordio.cc so that the
 * library has no undefined symbol. The message is per thread, as in
 * engine.cc.
 */
#include <string>

#include "mxtpu.h"

namespace {
thread_local std::string g_last_error;
}  // namespace

void MXTSetLastError(const char *msg) { g_last_error = msg ? msg : ""; }

extern "C" const char *MXTGetLastError() { return g_last_error.c_str(); }
