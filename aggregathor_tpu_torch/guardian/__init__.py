"""Run health: the in-step probe (``probe``) the engine attaches to every
step's metrics.  The watchdog, rollback and escalation ladder of the JAX
package's ``guardian`` are not ported yet."""
