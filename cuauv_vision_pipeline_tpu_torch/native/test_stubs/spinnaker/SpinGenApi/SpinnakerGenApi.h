// COMPILE-CHECK STUB — the GenApi pieces live in Spinnaker.h here.
#pragma once
#include "../Spinnaker.h"
