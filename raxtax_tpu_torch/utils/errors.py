"""BSD-style exit codes (reference: exitcode crate, src/main.rs:29-172)."""

OK = 0
OSERR = 71
CANTCREAT = 73
IOERR = 74
TEMPFAIL = 75
NOINPUT = 66
