"""The port's walk-throughs: one image scrambled, solved and drawn
(``demo_walkthrough``), and with pieces blacked out (``masked_patches_demo``)."""
