"""The named-failpoint registry the structured compiler fires through."""
